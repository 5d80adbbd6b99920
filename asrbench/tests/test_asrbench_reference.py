"""The plain reference agrees with the port's plain route at a small size
on the CPU: the log-mel, the eval and training forwards, the CTC loss and
its gradients, and Novograd."""

import copy

import numpy as np
import pytest
import torch

from asrbench import core, synth, weights
from asrbench.drivers import common
from asrbench.reference import logmel, quartznet, train

NARROW = [
    {"filters": 32, "repeat": 1, "kernel": [11], "stride": [2],
     "dilation": [1], "dropout": 0.0, "residual": False, "separable": True},
    {"filters": 32, "repeat": 2, "kernel": [7], "stride": [1],
     "dilation": [1], "dropout": 0.0, "residual": True, "separable": True},
    {"filters": 48, "repeat": 1, "kernel": [9], "stride": [1],
     "dilation": [2], "dropout": 0.0, "residual": False, "separable": True},
    {"filters": 64, "repeat": 1, "kernel": [1], "stride": [1],
     "dilation": [1], "dropout": 0.0, "residual": False, "separable": False},
]


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    from vietasr_tpu_torch.config import load_config
    cfg = dict(core.config("qn12x1_vi"), name="narrow", blocks=NARROW)
    mcfg = load_config(common.write_yaml(cfg, str(tmp_path_factory.mktemp(
        "cfg"))))
    v = weights.seeded_variables(NARROW, 64, len(cfg["labels"]) + 1, 5,
                                 torch.device("cpu"))
    # BN away from identity, so that the comparison sees it
    for leaf, val in (("mean", 0.3), ("var", 1.7)):
        for blk in v["batch_stats"]["encoder"]:
            for part in blk["sub"] + blk["res"]:
                part["bn"][leaf] = torch.full_like(part["bn"][leaf], val)
    sigs, texts = synth.utterances(9, 4, 1.5, 3.0, cfg["labels"])
    return cfg, mcfg, v, sigs, texts


def _batch(sigs):
    n = max(len(s) for s in sigs)
    x = np.zeros((len(sigs), n), np.float32)
    for i, s in enumerate(sigs):
        x[i, :len(s)] = s
    return (torch.from_numpy(x),
            torch.tensor([len(s) for s in sigs], dtype=torch.int32))


def test_log_mel_matches_the_ports_plain_chain(narrow):
    from vietasr_tpu_torch.frontend.features import make_featurizer
    cfg, mcfg, _, sigs, _ = narrow
    x, lens = _batch(sigs)
    want, want_len = make_featurizer(mcfg.featurizer, device="cpu")(x, lens)
    got, got_len = logmel.log_mel(x, lens, cfg["featurizer"])
    assert torch.equal(got_len, want_len.to(got_len.dtype))
    assert got.shape == want.shape
    # the port's fp32 DFT against the reference's fp64 FFT
    assert float((got - want).abs().max()) < 1e-3


@pytest.mark.parametrize("training", [False, True])
def test_forward_matches_quartznet_apply(narrow, training):
    from vietasr_tpu_torch.models.quartznet import quartznet_apply
    cfg, mcfg, v, sigs, _ = narrow
    x, lens = _batch(sigs)
    feats, flen = logmel.log_mel(x, lens, cfg["featurizer"])
    out = quartznet_apply(v, feats, flen, cfg=mcfg.encoder,
                          block_impl="plain", training=training)
    got, got_len = quartznet.forward(v, feats, flen, NARROW,
                                     training=training)
    assert torch.equal(got_len, out[1])
    assert float((got - out[0]).abs().max()) < 1e-4


def test_loss_and_gradients_match_the_ports_loss(narrow):
    from vietasr_tpu_torch.audio.tokenizer import CharTokenizer
    from vietasr_tpu_torch.train.loop import make_loss_fn
    cfg, mcfg, v, sigs, texts = narrow
    x, lens = _batch(sigs)
    ids = [CharTokenizer(cfg["labels"]).encode(t) for t in texts]
    tokens = np.zeros((len(ids), max(map(len, ids))), np.int32)
    for i, t in enumerate(ids):
        tokens[i, :len(t)] = t
    batch = {"signal": x.numpy(), "signal_lens": lens.numpy(),
             "tokens": tokens,
             "token_lens": np.array([len(t) for t in ids], np.int32)}
    params = copy.deepcopy(v["params"])
    leaves = train.flat_leaves(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss_fn = make_loss_fn(mcfg, ctc_impl="plain", device="cpu")
    gen = torch.Generator().manual_seed(3)
    loss, _ = loss_fn(params, v["batch_stats"],
                      {k: torch.from_numpy(a) for k, a in batch.items()},
                      gen, True)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    model = {"featurizer": cfg["featurizer"], "blocks": NARROW,
             "labels": cfg["labels"]}
    r_loss, r_grads = train.loss_and_grads(
        copy.deepcopy(v["params"]), v["batch_stats"], batch, noise, model)
    loss = float(loss.detach())
    assert abs(loss - float(r_loss)) < 1e-4 * abs(float(r_loss))
    for (k, g) in zip(leaves, grads):
        ref = r_grads[k]
        assert float((g - ref).norm()) <= 1e-3 * float(ref.norm()) + 1e-7, k


def test_novograd_matches_the_ports():
    from vietasr_tpu_torch.train.optim import Novograd
    gen = torch.Generator().manual_seed(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) * 4 for s in shapes]
             for _ in range(3)]
    mine = {str(i): p.clone() for i, p in enumerate(params)}
    ref = train.Novograd(0.01, (0.95, 0.98), 1e-8, 0.001, 5.0)
    port_params = [p.clone() for p in params]
    port = Novograd(port_params, 0.01, weight_decay=0.001,
                    grad_clip_norm=5.0)
    for step in grads:
        ref.step(mine, {str(i): g for i, g in enumerate(step)})
        for p, g in zip(port_params, step):
            p.grad = g.clone()
        port.step()
    for i, p in enumerate(port_params):
        assert torch.allclose(mine[str(i)], p, atol=1e-6, rtol=1e-6)
    # the first norms are those of the first gradients after clipping
    first = grads[0]
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in first)))
    scale = min(1.0, 5.0 / norm)
    for i, g in enumerate(first):
        assert ref.first_norms[str(i)] == pytest.approx(
            float(g.norm()) * scale, rel=1e-6)
