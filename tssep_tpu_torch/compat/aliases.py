"""Factory-path aliases: port of ``tssep_tpu/compat/aliases.py``. Configs
written for the torch reference (``tssep.train.*`` dotted paths) resolve to
the port's classes, so a user can point the port at an existing reference
``config.yaml``. The targets are the JAX package's paths under
``tssep_tpu_torch.``.
"""

from tssep_tpu_torch.config.configurable import register_alias

_ALIASES = {
    # feature extractors
    'tssep.train.feature_extractor.Log1pMaxNormAbsSTFT':
        'tssep_tpu_torch.features.extractor.Log1pMaxNormAbsSTFT',
    'tssep.train.feature_extractor.MVNLog1pAbsSTFT':
        'tssep_tpu_torch.features.extractor.MVNLog1pAbsSTFT',
    'tssep.train.feature_extractor.Log1pAbsIPDSTFT':
        'tssep_tpu_torch.features.extractor.Log1pAbsIPDSTFT',
    'tssep.train.feature_extractor.Log1pMaxNormAbsIPDSTFT':
        'tssep_tpu_torch.features.extractor.Log1pMaxNormAbsIPDSTFT',
    'tssep.train.feature_extractor.NoFeatureSTFT':
        'tssep_tpu_torch.features.extractor.NoFeatureSTFT',
    'tssep.train.feature_extractor.ConcaternatedSTFTFeatures':
        'tssep_tpu_torch.features.extractor.ConcatenatedSTFTFeatures',
    'tssep.train.feature_extractor.TorchMFCC':
        'tssep_tpu_torch.features.extractor.MFCC',
    'tssep.train.feature_extractor_torchaudio.TorchMFCC':
        'tssep_tpu_torch.features.extractor.MFCC',
    'tssep.train.feature_extractor.STFT':
        'tssep_tpu_torch.features.extractor.STFTFeatures',
    'tssep.train.feature_extractor.AbsSTFT':
        'tssep_tpu_torch.features.extractor.AbsSTFT',
    'tssep.train.feature_extractor.Log1pAbsSTFT':
        'tssep_tpu_torch.features.extractor.Log1pAbsSTFT',
    'tssep.train.feature_extractor.KaldiTorchMFCC':
        'tssep_tpu_torch.features.kaldi.KaldiMFCC',
    'tssep.train.feature_extractor.KaldiTorch':
        'tssep_tpu_torch.features.kaldi.FuncFeature',
    # data
    'tssep.data.DummyReader': 'tssep_tpu_torch.data.dummy.DummyReader',
    # network
    'tssep.train.net.MaskEstimator_v2': 'tssep_tpu_torch.nn.estimator.MaskEstimator',
    'tssep.train.net.AuxNet': 'tssep_tpu_torch.nn.estimator.AuxNet',
    'tssep.train.net.Linear': 'tssep_tpu_torch.nn.estimator.LinearAux',
    'tssep.train.net.InstanceNorm': 'tssep_tpu_torch.nn.norm.InstanceNorm',
    'tssep.train.net.InstanceNorm_v2': 'tssep_tpu_torch.nn.norm.InstanceNorm_v2',
    # enhancers
    'tssep.train.enhancer.Masking': 'tssep_tpu_torch.tasks.enhancer.Masking',
    'tssep.train.enhancer.Nothing': 'tssep_tpu_torch.tasks.enhancer.Nothing',
    'tssep.train.enhancer.Dummy': 'tssep_tpu_torch.tasks.enhancer.Dummy',
    'tssep.train.enhancer.TorchBF': 'tssep_tpu_torch.tasks.enhancer.SoudenMVDR',
    'tssep.train.enhancer.ClassicBF_np': 'tssep_tpu_torch.eval.classic_bf.ClassicBF',
    'tssep.train.enhancer.WPE': 'tssep_tpu_torch.eval.wpe.WPE',
    'tssep.train.enhancer.ChannelWiseWPE': 'tssep_tpu_torch.eval.wpe.ChannelWiseWPE',
    'tssep.train.enhancer_distortion_mask.OneMinus':
        'tssep_tpu_torch.eval.classic_bf.OneMinus',
    'tssep.train.enhancer_distortion_mask.SumCrossTalker':
        'tssep_tpu_torch.eval.classic_bf.SumCrossTalker',
    # losses
    'tssep.train.loss.MSE': 'tssep_tpu_torch.tasks.losses.MSE',
    'tssep.train.loss.MAE': 'tssep_tpu_torch.tasks.losses.MAE',
    'tssep.train.loss.LogMAE': 'tssep_tpu_torch.tasks.losses.LogMAE',
    'tssep.train.loss.FreqMSE': 'tssep_tpu_torch.tasks.losses.FreqMSE',
    'tssep.train.loss.VADSigmoidBCE': 'tssep_tpu_torch.tasks.losses.VADSigmoidBCE',
    'tssep.train.loss.SignalAndVADSigmoidBCE':
        'tssep_tpu_torch.tasks.losses.SignalAndVADSigmoidBCE',
    # model / experiment / runtime
    'tssep.train.model.Model': 'tssep_tpu_torch.tasks.model.Model',
    'tssep.train.experiment.Experiment':
        'tssep_tpu_torch.train.experiment.Experiment',
    'tssep.train.init_ckpt.InitCheckPoint':
        'tssep_tpu_torch.train.init_ckpt.InitCheckPoint',
    'tssep.train.init_ckpt.InitCheckPointVAD2Sep':
        'tssep_tpu_torch.train.init_ckpt.InitCheckPointVAD2Sep',
    'padertorch.train.trainer.Trainer': 'tssep_tpu_torch.train.trainer.Trainer',
    'padertorch.train.optimizer.Adam': 'tssep_tpu_torch.train.optimizer.Adam',
    'padertorch.train.optimizer.SGD': 'tssep_tpu_torch.train.optimizer.SGD',
}


def register_reference_aliases():
    for alias, target in _ALIASES.items():
        register_alias(alias, target)


register_reference_aliases()
