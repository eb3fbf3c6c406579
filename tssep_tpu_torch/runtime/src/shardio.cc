// Record-shard store: length-prefixed raw tensors with a trailing index.
// Purpose: feed the host input pipeline from large preprocessed corpora
// (simulated meetings) without Python-level parsing per example.
//
// Format (little endian):
//   [record 0][record 1]...[record N-1][index][footer]
//   record: u32 key_len, key bytes, u32 dtype, u32 ndim, u64 shape[ndim],
//           u64 payload_bytes, payload
//   index:  N * u64 record offsets
//   footer: u64 index_offset, u64 N, magic "TSSHARD1"
//
// dtype codes: 0=f32, 1=f64, 2=i32, 3=i64, 4=u8(bool/bytes), 5=c64

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

struct ShardWriter {
  FILE* f;
  std::vector<uint64_t> offsets;
};

ShardWriter* shard_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new ShardWriter();
  w->f = f;
  return w;
}

int shard_writer_add(ShardWriter* w, const char* key, int32_t dtype,
                     int32_t ndim, const uint64_t* shape,
                     const void* payload, uint64_t payload_bytes) {
  w->offsets.push_back((uint64_t)ftell(w->f));
  uint32_t key_len = (uint32_t)strlen(key);
  fwrite(&key_len, 4, 1, w->f);
  fwrite(key, 1, key_len, w->f);
  uint32_t d = (uint32_t)dtype, nd = (uint32_t)ndim;
  fwrite(&d, 4, 1, w->f);
  fwrite(&nd, 4, 1, w->f);
  fwrite(shape, 8, (size_t)ndim, w->f);
  fwrite(&payload_bytes, 8, 1, w->f);
  fwrite(payload, 1, (size_t)payload_bytes, w->f);
  return 0;
}

int shard_writer_close(ShardWriter* w) {
  uint64_t index_offset = (uint64_t)ftell(w->f);
  fwrite(w->offsets.data(), 8, w->offsets.size(), w->f);
  uint64_t n = w->offsets.size();
  fwrite(&index_offset, 8, 1, w->f);
  fwrite(&n, 8, 1, w->f);
  fwrite("TSSHARD1", 1, 8, w->f);
  fclose(w->f);
  delete w;
  return 0;
}

// Reader: returns number of records, fills offsets array (caller allocates
// after calling with offsets=null to get the count).
int64_t shard_count(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, -24, SEEK_END)) { fclose(f); return -2; }
  uint64_t index_offset, n;
  char magic[8];
  if (fread(&index_offset, 8, 1, f) != 1 || fread(&n, 8, 1, f) != 1 ||
      fread(magic, 1, 8, f) != 8 || memcmp(magic, "TSSHARD1", 8)) {
    fclose(f); return -3;
  }
  fclose(f);
  return (int64_t)n;
}

int shard_offsets(const char* path, uint64_t* out, int64_t n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, -24, SEEK_END)) { fclose(f); return -2; }
  uint64_t index_offset, count;
  if (fread(&index_offset, 8, 1, f) != 1 ||
      fread(&count, 8, 1, f) != 1) { fclose(f); return -3; }
  if ((int64_t)count != n) { fclose(f); return -4; }
  if (fseek(f, (long)index_offset, SEEK_SET)) { fclose(f); return -5; }
  if (fread(out, 8, (size_t)n, f) != (size_t)n) { fclose(f); return -6; }
  fclose(f);
  return 0;
}

// Read the record header at `offset`: fills key (cap key_cap), dtype, ndim,
// shape (cap 8), payload_bytes, and payload_offset (file position of data).
int shard_record_header(const char* path, uint64_t offset, char* key,
                        int32_t key_cap, int32_t* dtype, int32_t* ndim,
                        uint64_t* shape, uint64_t* payload_bytes,
                        uint64_t* payload_offset) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, (long)offset, SEEK_SET)) { fclose(f); return -2; }
  uint32_t key_len;
  if (fread(&key_len, 4, 1, f) != 1 || (int32_t)key_len >= key_cap) {
    fclose(f); return -3;
  }
  if (fread(key, 1, key_len, f) != key_len) { fclose(f); return -4; }
  key[key_len] = 0;
  uint32_t d, nd;
  if (fread(&d, 4, 1, f) != 1 || fread(&nd, 4, 1, f) != 1 || nd > 8) {
    fclose(f); return -5;
  }
  if (fread(shape, 8, nd, f) != nd) { fclose(f); return -6; }
  if (fread(payload_bytes, 8, 1, f) != 1) { fclose(f); return -7; }
  *dtype = (int32_t)d;
  *ndim = (int32_t)nd;
  *payload_offset = (uint64_t)ftell(f);
  fclose(f);
  return 0;
}

int shard_read_payload(const char* path, uint64_t payload_offset,
                       void* out, uint64_t nbytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, (long)payload_offset, SEEK_SET)) { fclose(f); return -2; }
  size_t got = fread(out, 1, (size_t)nbytes, f);
  fclose(f);
  return got == nbytes ? 0 : -3;
}

}  // extern "C"
