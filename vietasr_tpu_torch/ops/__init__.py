from vietasr_tpu_torch.ops.ctc_loss import ctc_loss
from vietasr_tpu_torch.ops.greedy import (collapse_batch, ctc_collapse,
                                          greedy_decode, greedy_transcripts,
                                          ids_to_text)
from vietasr_tpu_torch.ops.repeat_block import (block_eligible,
                                                fused_repeat_block)
from vietasr_tpu_torch.ops.specaug import (apply_spec_augment, spec_augment,
                                           spec_cutout)

__all__ = ["ctc_loss", "collapse_batch", "ctc_collapse", "greedy_decode",
           "greedy_transcripts", "ids_to_text", "block_eligible",
           "fused_repeat_block", "spec_augment", "spec_cutout",
           "apply_spec_augment"]
