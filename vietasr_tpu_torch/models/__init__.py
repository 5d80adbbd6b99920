from vietasr_tpu_torch.models.conformer import (conformer_apply,
                                                init_conformer)
from vietasr_tpu_torch.models.convert import load_anchor, params_from_jax
from vietasr_tpu_torch.models.quartznet import (QuartzNet, fold_batchnorm,
                                                init_quartznet,
                                                quartznet_apply)


def model_init(generator, cfg, *, device=None) -> dict:
    """Architecture dispatch over a ModelConfig: the unfolded variables
    tree drawn from `generator` (a torch.Generator)."""
    if cfg.architecture == "conformer":
        return init_conformer(
            generator, cfg.conformer,
            cfg.featurizer.features * cfg.featurizer.frame_splicing,
            cfg.num_classes, device=device)
    return init_quartznet(generator, cfg.encoder, cfg.num_classes,
                          device=device)


def model_apply(variables, feats, feat_lens, *, cfg, **kwargs):
    """Architecture dispatch of the forward: (log_probs, out_lens) in eval
    mode."""
    if cfg.architecture == "conformer":
        return conformer_apply(variables, feats, feat_lens,
                               cfg=cfg.conformer, **kwargs)
    return quartznet_apply(variables, feats, feat_lens, cfg=cfg.encoder,
                           **kwargs)


__all__ = ["QuartzNet", "load_anchor", "params_from_jax", "fold_batchnorm",
           "quartznet_apply", "init_quartznet", "init_conformer",
           "conformer_apply", "model_init", "model_apply"]
