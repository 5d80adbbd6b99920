"""The port's API leftovers vs the JAX package's: config_to_dict /
save_config on the shipped YAMLs, assert_features, greedy_transcripts, the
QuartzNet facade, utils/ (env getters, the logger, `deprecated`,
ExpManager, under a 2-rank gloo group too), the aliases and every package
re-export of the JAX `__init__`s."""

import ast
import dataclasses
import glob
import importlib
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_worker as W
from vietasr_tpu import config as jax_config
from vietasr_tpu.models import quartznet as jax_qn
from vietasr_tpu.ops import greedy as jax_greedy
from vietasr_tpu.utils import env as jax_env
from vietasr_tpu.utils import exp_manager as jax_exp
from vietasr_tpu.utils import typing as jax_typing
from vietasr_tpu_torch import config
from vietasr_tpu_torch.models import quartznet as qn
from vietasr_tpu_torch.models.convert import params_from_jax
from vietasr_tpu_torch.ops import greedy
from vietasr_tpu_torch.utils import env, exp_manager
from vietasr_tpu_torch.utils import typing as port_typing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                                      "*.yaml")))


def test_seven_shipped_configs():
    assert len(YAMLS) == 7


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_config_round_trip_and_save_match_jax(tmp_path, path):
    cfg = config.load_config(path)
    raw = config.config_to_dict(cfg)
    assert config.config_from_dict(raw) == cfg
    assert raw == jax_config.config_to_dict(jax_config.load_config(path))
    config.save_config(cfg, str(tmp_path / "port.yaml"))
    jax_config.save_config(jax_config.load_config(path),
                           str(tmp_path / "jax.yaml"))
    assert (tmp_path / "port.yaml").read_bytes() \
        == (tmp_path / "jax.yaml").read_bytes()
    assert config.load_config(str(tmp_path / "port.yaml")) == cfg


@pytest.mark.parametrize("shape,n_features,dtype", [
    ((2, 50, 64), 64, "float32"),      # fine
    ((2, 64, 50), 64, "float32"),      # transposed
    ((2, 50, 80), 64, "float32"),      # wrong width
    ((50, 64), 64, "float32"),         # no batch axis
    ((2, 50, 64), 64, "int32"),        # not float
    ((2, 50, 64), None, "bfloat16"),
])
def test_assert_features_matches_jax(shape, n_features, dtype):
    x = torch.zeros(shape, dtype=getattr(torch, dtype))
    jx = jnp.zeros(shape, getattr(jnp, dtype))

    def outcome(fn, arr, err):
        try:
            fn(arr, n_features=n_features, port="enc.feats")
        except err as e:
            return str(e).replace("torch.", "")
        return None

    got = outcome(port_typing.assert_features, x, port_typing.ContractError)
    want = outcome(jax_typing.assert_features, jx, jax_typing.ContractError)
    assert got == want
    if shape == (2, 64, 50):
        assert "TRANSPOSED" in got


def test_greedy_transcripts_match_jax():
    labels = list(" abcdeghi")
    rng = np.random.RandomState(0)
    lp = np.log(rng.dirichlet(np.ones(len(labels) + 1), size=(4, 30))) \
        .astype(np.float32)
    lp[:, ::3, -1] = 0.0                                  # blanks
    lens = np.array([30, 17, 1, 0], np.int32)
    got = greedy.greedy_transcripts(torch.from_numpy(lp),
                                    torch.from_numpy(lens), labels)
    want = jax_greedy.greedy_transcripts(jnp.asarray(lp), jnp.asarray(lens),
                                         labels)
    assert got == want and got[3] == "" and len(got[0]) > 3


def _narrow_encoder():
    blocks = (config.BlockConfig(filters=16, kernel=5, separable=True),
              config.BlockConfig(filters=16, kernel=3, separable=True,
                                 repeat=2),
              config.BlockConfig(filters=24, kernel=1, residual=False))
    return config.EncoderConfig(blocks=blocks, feat_in=8)


def test_quartznet_facade():
    ecfg = _narrow_encoder()
    model = qn.QuartzNet(ecfg, 5)
    v = model.init(torch.Generator().manual_seed(0), device="cpu")
    want = qn.init_quartznet(torch.Generator().manual_seed(0), ecfg, 5,
                             device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(qn.tree_leaves(v),
                                                 qn.tree_leaves(want)))
    feats = torch.randn(2, 20, 8, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([20, 11])
    out = model.apply(v, feats, lens)
    assert len(out) == 2                     # JAX's eval mode returns 3
    lp, out_lens = out
    ref_lp, ref_lens = qn.quartznet_apply(v, feats, lens, cfg=ecfg)
    assert torch.equal(lp, ref_lp) and torch.equal(out_lens, ref_lens)
    assert lp.shape == (2, 20, 6)
    assert len(model.apply(v, feats, lens, training=True,
                           generator=torch.Generator().manual_seed(2))) == 3
    folded = model.fold(v)
    assert "bn" not in folded["params"]["encoder"][0]["sub"][0]
    np.testing.assert_allclose(model.apply(folded, feats, lens)[0].numpy(),
                               lp.numpy(), atol=1e-5)


def test_quartznet_facade_on_jax_weights_matches_jax():
    jcfg = jax_config.EncoderConfig(
        blocks=tuple(jax_config.BlockConfig(**dataclasses.asdict(b))
                     for b in _narrow_encoder().blocks), feat_in=8)
    jmodel = jax_qn.QuartzNet(jcfg, 5)
    jv = jmodel.init(jax.random.PRNGKey(0))
    feats = np.random.RandomState(3).randn(2, 20, 8).astype(np.float32)
    lens = np.array([20, 11], np.int32)
    want = jmodel.apply(jv, jnp.asarray(feats), jnp.asarray(lens))
    got = qn.QuartzNet(_narrow_encoder(), 5).apply(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jv),
                        device="cpu"),
        torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# utils


@pytest.mark.parametrize("name,value,default", [
    ("get_envbool", " Yes ", ()), ("get_envbool", "off", ()),
    ("get_envbool", None, (True,)), ("get_envint", "42", ()),
    ("get_envint", None, (7,)), ("get_envfloat", "2.5e-3", ()),
    ("get_envlist", "a b  c", ()), ("get_env", "raw", ()),
    ("get_envdict", '{"a": [1, 2]}', ()), ("get_envint", None, ()),
    ("get_envint", "x", ()),
])
def test_env_getters_match_jax(monkeypatch, name, value, default):
    key = "VIETASR_TEST_ENV_KEY"
    if value is None:
        monkeypatch.delenv(key, raising=False)
    else:
        monkeypatch.setenv(key, value)

    def outcome(mod):
        try:
            return ("ok", getattr(mod, name)(key, *default))
        except Exception as e:            # the error's type name and text
            return (type(e).__name__, str(e))

    assert outcome(env) == outcome(jax_env)
    if value is None and not default:
        with pytest.raises(env.RequiredSettingMissing):
            getattr(env, name)(key)
    assert env.get_envlist(key, ["d"], separator=",") \
        == jax_env.get_envlist(key, ["d"], separator=",")


def test_enable_compilation_cache_has_no_counterpart():
    assert not hasattr(env, "enable_compilation_cache")
    assert "compilation cache" in env.__doc__


LOGGER_SCRIPT = r"""
import io, logging, os, sys
from vietasr_tpu_torch.utils import LogMode, deprecated, get_logger
from vietasr_tpu_torch.utils.logging import log_once

log = get_logger(log_file=sys.argv[1])
assert get_logger() is log
stderr = [h for h in log.handlers if type(h) is logging.StreamHandler]
print("console", len(stderr))
for _ in range(3):
    log_once(log, "only once")
    log.info("each time")

@deprecated(version="2.0", explanation="use new_fn")
def old_fn(x):
    return x + 1

assert old_fn(1) == 2 and old_fn(2) == 3
assert old_fn.__name__ == "old_fn"
for h in log.handlers:
    h.flush()
"""


@pytest.mark.parametrize("rank", [None, "0", "3"])
def test_logger_console_file_and_once(tmp_path, rank):
    """In a fresh process: the console on rank 0 only (RANK without a
    process group), %r in the file name, LogMode.ONCE and `deprecated`
    logged once."""
    env_ = dict(os.environ, PYTHONPATH=ROOT)
    env_.pop("RANK", None)
    if rank is not None:
        env_["RANK"] = rank
    out = subprocess.run(
        [sys.executable, "-c", LOGGER_SCRIPT, str(tmp_path / "log-%r.txt")],
        env=env_, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    r = rank or "0"
    assert out.stdout.split() == ["console", "1" if r == "0" else "0"]
    text = (tmp_path / f"log-{r}.txt").read_text()
    assert text.count("only once") == 1 and text.count("each time") == 3
    assert text.count("old_fn is deprecated and will be removed in 2.0. "
                      "use new_fn") == 1
    assert ("only once" in out.stderr) == (r == "0")


def _tree(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out[rel] = sorted(files)
    return out


def test_exp_manager_matches_jax(tmp_path):
    cfg_file = YAMLS[0]
    made = {}
    for who, mod in (("port", exp_manager), ("jax", jax_exp)):
        work = str(tmp_path / who)
        exp = mod.ExpManager(work, use_timestamp=False,
                             config_files=[cfg_file])
        assert exp.work_dir == work and exp.is_main
        assert exp.checkpoint_dir == os.path.join(work, "checkpoints")
        exp.log_metrics({"loss": 1.25, "wer": 0.5, "text": "xin chào"},
                        step=3)
        exp.log_metrics({"lr": 1e-3})
        exp.close()
        made[who] = work
    assert _tree(made["port"]) == _tree(made["jax"])
    assert "metrics.jsonl" in _tree(made["port"])["."]
    for name in ("metrics.jsonl", "cmd-args.log",
                 os.path.basename(cfg_file)):
        with open(os.path.join(made["port"], name), "rb") as a, \
                open(os.path.join(made["jax"], name), "rb") as b:
            assert a.read() == b.read(), name
    heads = []
    for who in made:
        path = os.path.join(made[who], "git-info.log")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                heads.append(f.readline())
    assert len(heads) in (0, 2) and len(set(heads)) <= 1
    lines = [json.loads(l) for l in open(os.path.join(made["port"],
                                                      "metrics.jsonl"))]
    assert lines == [{"loss": 1.25, "wer": 0.5, "text": "xin chào",
                      "step": 3}, {"lr": 1e-3}]


def test_logger_and_exp_manager_under_two_gloo_ranks(tmp_path):
    """The logger takes its rank from the process group (not RANK), its
    console is on rank 0 only and each rank writes its own file; the
    ExpManager's timestamped work dir is the same on both ranks and only
    rank 0 writes into it."""
    tmp = str(tmp_path)
    out = W.run("logging", 2, tmp, payload={"dir": tmp})
    assert [o["rank"] for o in out] == [0, 1]
    assert [o["console"] for o in out] == [1, 0]
    assert [o["is_main"] for o in out] == [True, False]
    assert out[0]["work_dir"] == out[1]["work_dir"]
    for r in (0, 1):
        text = (tmp_path / f"log-{r}.txt").read_text()
        assert f"hello from rank {r}" in text
    work = out[0]["work_dir"]
    assert os.path.dirname(work) == os.path.join(tmp, "exp")
    lines = [json.loads(l) for l in open(os.path.join(work,
                                                      "metrics.jsonl"))]
    assert lines == [{"loss": 1.5, "step": 0}]
    assert os.path.exists(os.path.join(work, "cmd-args.log"))


# ---------------------------------------------------------------------------
# aliases and re-exports


def test_warmup_hold_cosine_and_novograd():
    from vietasr_tpu_torch.train import optim, schedules

    assert schedules.warmup_hold_cosine is schedules.warmup_cosine
    p = torch.zeros(3, requires_grad=True)
    opt = optim.novograd(0.1, betas=(0.9, 0.99), weight_decay=0.01,
                         grad_averaging=True)([p])
    assert isinstance(opt, optim.Novograd)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.99) and group["weight_decay"] == 0.01
    assert group["grad_averaging"] and opt.learning_rate == 0.1
    ref = optim.make_optimizer("novograd", 0.1, betas=(0.9, 0.99),
                               weight_decay=0.01)([torch.zeros(3)])
    assert ref.param_groups[0]["eps"] == group["eps"]


def _jax_all(package: str) -> list:
    path = os.path.join(ROOT, "vietasr_tpu", package, "__init__.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no __all__ in {path}")


PACKAGES = ["audio", "frontend", "models", "ops", "parallel", "train",
            "utils"]


@pytest.mark.parametrize("package", PACKAGES)
def test_every_jax_export_is_importable_from_the_port(package):
    names = _jax_all(package)
    assert names
    mod = importlib.import_module(f"vietasr_tpu_torch.{package}")
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, missing
    assert set(names) <= set(mod.__all__)


def test_train_exports_freeze():
    from vietasr_tpu_torch import train

    for name in ("freeze", "unfreeze_schedule", "make_value_schedule"):
        assert callable(getattr(train, name))
