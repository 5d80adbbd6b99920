"""Config system: typed dataclasses + NeMo-sectioned YAML ingestion
(counterpart of vietasr_tpu/config.py, restricted to what a QuartzNet
config needs).

Reads the section-per-component YAML shape (`AudioToMelSpectrogram
Preprocessor`, `SpectrogramAugmentation`, `JasperEncoder`, `labels`), so
the same file loads here and in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import yaml

from vietasr_tpu_torch.frontend.features import FeaturizerConfig


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One encoder block (JasperBlock kwargs)."""

    filters: int
    repeat: int = 1
    kernel: int = 11
    stride: int = 1
    dilation: int = 1
    dropout: float = 0.0
    residual: bool = True
    residual_dense: bool = False
    separable: bool = False
    groups: int = 1
    heads: int = -1
    se: bool = False
    se_reduction_ratio: int = 16
    kernel_size_factor: float = 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "BlockConfig":
        d = dict(d)
        for key in ("kernel", "stride", "dilation"):
            v = d.get(key)
            if isinstance(v, (list, tuple)):
                d[key] = v[0]
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def effective_kernel(self) -> int:
        """kernel_size_factor rescaling, rounded up to odd."""
        k = max(int(self.kernel * float(self.kernel_size_factor)), 1)
        return k + 1 if k % 2 == 0 else k

    @property
    def same_padding(self) -> int:
        """'same' padding for the block's convs."""
        if self.stride > 1 and self.dilation > 1:
            raise ValueError("only stride OR dilation may exceed 1")
        if self.dilation > 1:
            return (self.dilation * self.effective_kernel) // 2 - 1
        return self.effective_kernel // 2


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """JasperEncoder kwargs."""

    blocks: Sequence[BlockConfig]
    feat_in: int = 64
    activation: str = "relu"
    conv_mask: bool = True
    frame_splicing: int = 1
    residual_mode: str = "add"
    normalization_mode: str = "batch"
    init_mode: str = "xavier_uniform"


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    """SpectrogramAugmentation kwargs (parsed and kept; training only)."""

    freq_masks: int = 0
    time_masks: int = 0
    freq_width: int = 10
    time_width: int = 10
    rect_masks: int = 0
    rect_time: int = 5
    rect_freq: int = 20

    @classmethod
    def from_dict(cls, d: dict) -> "SpecAugmentConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    labels: List[str]
    featurizer: FeaturizerConfig
    encoder: EncoderConfig
    spec_augment: SpecAugmentConfig
    architecture: str = "quartznet"
    # the raw `ConformerEncoder` section, kept unparsed until the Conformer
    # is ported
    conformer: Optional[dict] = None

    @property
    def num_classes(self) -> int:
        """Vocabulary size without the CTC blank (blank id == num_classes)."""
        return len(self.labels)


def load_config(path: str) -> ModelConfig:
    """Load a model config from NeMo-style sectioned YAML."""
    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f)
    return config_from_dict(raw)


def config_from_dict(raw: dict) -> ModelConfig:
    feat_cfg = FeaturizerConfig.from_dict(
        raw.get("AudioToMelSpectrogramPreprocessor", {}))
    enc_raw = raw.get("JasperEncoder", {})
    blocks = tuple(BlockConfig.from_dict(b) for b in enc_raw.get("jasper", []))
    enc_cfg = EncoderConfig(
        blocks=blocks,
        feat_in=feat_cfg.features * feat_cfg.frame_splicing,
        activation=enc_raw.get("activation", "relu"),
        conv_mask=enc_raw.get("conv_mask", True),
        frame_splicing=feat_cfg.frame_splicing,
        residual_mode=enc_raw.get("residual_mode", "add"),
        normalization_mode=enc_raw.get("normalization_mode", "batch"),
        init_mode=enc_raw.get("init_mode", "xavier_uniform"),
    )
    conformer = raw.get("ConformerEncoder")
    return ModelConfig(
        name=raw.get("model", "model"),
        labels=list(raw.get("labels", [])),
        featurizer=feat_cfg,
        encoder=enc_cfg,
        spec_augment=SpecAugmentConfig.from_dict(
            raw.get("SpectrogramAugmentation", {})),
        architecture="conformer" if conformer is not None else "quartznet",
        conformer=conformer,
    )
