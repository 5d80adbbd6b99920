from vietasr_tpu_torch.audio.dataset import Batch
from vietasr_tpu_torch.audio.tokenizer import CharTokenizer

__all__ = ["Batch", "CharTokenizer"]
