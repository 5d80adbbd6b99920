from vietasr_tpu_torch.ops.greedy import (collapse_batch, ctc_collapse,
                                          greedy_decode, ids_to_text)
from vietasr_tpu_torch.ops.repeat_block import (block_eligible,
                                                fused_repeat_block)

__all__ = ["collapse_batch", "ctc_collapse", "greedy_decode", "ids_to_text",
           "block_eligible", "fused_repeat_block"]
