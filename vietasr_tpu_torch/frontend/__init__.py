from vietasr_tpu_torch.frontend.mel import mel_filterbank
from vietasr_tpu_torch.frontend.features import (
    FeaturizerConfig,
    log_mel_features,
    make_featurizer,
    feature_seq_len,
)

__all__ = [
    "mel_filterbank",
    "FeaturizerConfig",
    "log_mel_features",
    "make_featurizer",
    "feature_seq_len",
]
