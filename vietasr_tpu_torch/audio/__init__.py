from vietasr_tpu_torch.audio.io import (AudioSegment, read_audio, resample,
                                        trim_silence)
from vietasr_tpu_torch.audio.manifest import ManifestEntry, read_manifest
from vietasr_tpu_torch.audio.tokenizer import CharTokenizer
from vietasr_tpu_torch.audio.dataset import (AudioTextDataset, Batch,
                                             BucketBatcher, pad_to_bucket)

__all__ = [
    "AudioSegment",
    "read_audio",
    "resample",
    "trim_silence",
    "read_manifest",
    "ManifestEntry",
    "CharTokenizer",
    "AudioTextDataset",
    "BucketBatcher",
    "Batch",
    "pad_to_bucket",
]
