from vietasr_tpu_torch.models.convert import load_anchor, params_from_jax
from vietasr_tpu_torch.models.quartznet import fold_batchnorm, quartznet_apply

__all__ = ["load_anchor", "params_from_jax", "fold_batchnorm",
           "quartznet_apply"]
