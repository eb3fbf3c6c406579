from tssep_tpu_torch.config.configurable import (  # noqa: F401
    Configurable, from_config, get_config, import_class, class_to_str,
    load_yaml, dump_yaml, dumps_yaml, NestedView, nested_merge,
    nested_get, nested_set, register_alias,
)
