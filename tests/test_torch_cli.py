"""vietasr_tpu_torch's command line (cli.py) on the CPU: train -> resume ->
eval -> transcribe on a narrow QuartzNet over a seeded manifest of WAVs,
eval on a JAX-written msgpack checkpoint against the JAX CLI's eval, the
augmentor recipe, and the refusals."""

import argparse
import json
import os

import jax
import numpy as np
import pytest
import yaml
from scipy.io import wavfile

from vietasr_tpu import cli as jax_cli
from vietasr_tpu.config import load_config as jax_load_config
from vietasr_tpu.models import model_init as jax_model_init
from vietasr_tpu.train import CheckpointManager as JaxCheckpoints
from vietasr_tpu.train import TrainState as JaxState
from vietasr_tpu.train import make_optimizer as jax_make_optimizer
from vietasr_tpu_torch import cli

TEXTS = ["ba con gà", "hai cái bát", "các bạn", "to nhỏ", "cá kho",
         "bà ba", "chào các bạn", "một hai ba"]
LABELS = sorted(set("".join(TEXTS)))
BLOCKS = [dict(filters=24, repeat=1, kernel=[11], stride=[2], dilation=[1],
               dropout=0.0, residual=False, separable=True),
          dict(filters=24, repeat=2, kernel=[7], stride=[1], dilation=[1],
               dropout=0.1, residual=True, separable=True),
          dict(filters=32, repeat=1, kernel=[1], stride=[1], dilation=[1],
               dropout=0.0, residual=False)]


def _config(tmp_path):
    path = tmp_path / "narrow.yaml"
    path.write_text(yaml.safe_dump({
        "model": "narrow",
        "AudioToTextDataLayer": {"max_duration": 3.0, "min_duration": 0.1},
        "AudioToMelSpectrogramPreprocessor": {
            "sample_rate": 16000, "window_size": 0.02,
            "window_stride": 0.01, "window": "hann",
            "normalize": "per_feature", "n_fft": 512, "features": 16,
            "dither": 0.00001, "pad_to": 16},
        "SpectrogramAugmentation": {"freq_masks": 1, "time_masks": 1,
                                    "freq_width": 4, "time_width": 5},
        "JasperEncoder": {"activation": "relu", "conv_mask": True,
                          "jasper": BLOCKS},
        "labels": LABELS}, allow_unicode=True), encoding="utf-8")
    return str(path)


def _manifest(tmp_path, name, durations, seed=0):
    lines = []
    for i, d in enumerate(durations):
        wav = tmp_path / f"{name}{i}.wav"
        x = np.random.RandomState(seed + i).randn(int(d * 16000)) * 3000
        wavfile.write(str(wav), 16000, x.clip(-32768, 32767)
                      .astype(np.int16))
        lines.append({"audio_filepath": str(wav), "duration": d,
                      "text": TEXTS[(seed + i) % len(TEXTS)]})
    path = tmp_path / f"{name}.json"
    path.write_text("".join(json.dumps(l, ensure_ascii=False) + "\n"
                            for l in lines), encoding="utf-8")
    return str(path)


def _json_lines(out: str):
    return [json.loads(l) for l in out.splitlines() if l.startswith("{")]


def test_train_resume_eval_transcribe(tmp_path, capsys):
    cfg = _config(tmp_path)
    train = _manifest(tmp_path, "train", [0.6, 1.2, 0.9, 1.7, 0.5, 1.4])
    evalm = _manifest(tmp_path, "eval", [0.8, 1.3, 0.7], seed=20)
    work = str(tmp_path / "work")
    argv = ["--device", "cpu", "train", "--config", cfg,
            "--train-manifest", train, "--eval-manifest", evalm,
            "--work-dir", work, "--batch-size", "2", "--warmup-steps", "1",
            "--augment", "speed,gain,noise,shift", "--log-every", "1",
            "--lr", "0.01"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    steps = [m for m in _json_lines(out) if "loss" in m]
    assert steps and all(np.isfinite(m["loss"]) for m in steps)
    n = steps[-1]["step"]
    assert f"done at step {n}" in out and "resumed" not in out
    assert os.listdir(work) == [f"state-STEP-{n}.pt"]

    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert f"resumed from step {n}" in out
    assert f"done at step {2 * n}" in out
    assert f"state-STEP-{2 * n}.pt" in os.listdir(work)

    assert cli.main(["--device", "cpu", "eval", "--config", cfg,
                     "--checkpoint-dir", work, "--manifest", evalm,
                     "--batch-size", "2"]) == 0
    result = _json_lines(capsys.readouterr().out)[-1]
    assert set(result) == {"eval_loss", "wer", "cer", "num_utts"}
    assert result["num_utts"] == 3 and np.isfinite(result["eval_loss"])

    wavs = [str(tmp_path / f"eval{i}.wav") for i in range(3)]
    for decoder in ("greedy", "device_beam"):
        assert cli.main(["--device", "cpu", "transcribe", "--config", cfg,
                         "--checkpoint-dir", work, "--decoder", decoder,
                         "--beam-width", "4", *wavs]) == 0
        lines = _json_lines(capsys.readouterr().out)
        assert [l["audio_filepath"] for l in lines] == wavs
        assert all(isinstance(l["pred_text"], str) for l in lines)
    assert cli.main(["--device", "cpu", "transcribe", "--config", cfg,
                     "--checkpoint-dir", work, str(tmp_path)]) == 0
    assert len(_json_lines(capsys.readouterr().out)) == 9


def test_eval_on_a_jax_checkpoint_matches_jax_cli(tmp_path, capsys):
    """A JAX TrainState saved as msgpack: the port's eval gives the JAX
    CLI's WER, CER and utterance count, and its loss within 1e-4."""
    cfg = _config(tmp_path)
    evalm = _manifest(tmp_path, "eval", [0.8, 1.3, 0.7, 2.2, 1.1], seed=3)
    ckpt = str(tmp_path / "jax_ckpt")
    jcfg = jax_load_config(cfg)
    variables = jax_model_init(jax.random.PRNGKey(4), jcfg)
    opt = jax_make_optimizer("novograd", 0.01)
    JaxCheckpoints(ckpt).save(JaxState.create(variables, opt), 7)
    args = argparse.Namespace(config=cfg, encoder_checkpoint=None,
                              decoder_checkpoint=None, checkpoint_dir=ckpt,
                              manifest=evalm, batch_size=2)
    assert jax_cli.cmd_eval(args) == 0
    want = _json_lines(capsys.readouterr().out)[-1]
    assert cli.main(["--device", "cpu", "eval", "--config", cfg,
                     "--checkpoint-dir", ckpt, "--manifest", evalm,
                     "--batch-size", "2"]) == 0
    got = _json_lines(capsys.readouterr().out)[-1]
    assert set(got) == set(want)
    assert (got["wer"], got["cer"], got["num_utts"]) \
        == (want["wer"], want["cer"], want["num_utts"]) \
        and got["num_utts"] == 5
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                               rtol=1e-4)


def test_build_augmentor_matches_jax():
    for spec in ("speed,gain,noise,shift", "speed:1.0,gain:0.5",
                 "noise:0.2"):
        got, g_margin = cli.build_augmentor(spec, seed=3)
        want, w_margin = jax_cli._build_augmentor(spec, seed=3)
        assert g_margin == w_margin
        assert [(p, type(t).__name__) for p, t in got._pipeline] \
            == [(p, type(t).__name__) for p, t in want._pipeline]
        for i in range(5):
            sig = (np.random.RandomState(i).randn(7000 + 100 * i) * 0.1) \
                .astype(np.float32)
            assert np.array_equal(got(sig.copy(), 16000),
                                  want(sig.copy(), 16000))
    with pytest.raises(SystemExit):
        cli.build_augmentor("reverb")


def test_arguments_and_defaults_match_jax_cli(monkeypatch):
    """Every subcommand takes the JAX CLI's options with its defaults;
    --platform becomes --device (default cuda)."""
    captured = {}

    class Stop(Exception):
        pass

    def parse_args(self, argv=None):
        captured["parser"] = self
        raise Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(Stop):
        jax_cli.main([])
    monkeypatch.undo()
    port, ref = cli.build_parser(), captured["parser"]

    def options(parser):
        subs = next(a for a in parser._actions
                    if isinstance(a, argparse._SubParsersAction))
        return {name: {a.dest: (a.default, a.required)
                       for a in sp._actions if a.dest != "help"}
                for name, sp in subs.choices.items()}

    got, want = options(port), options(ref)
    assert sorted(got) == sorted(want) == ["eval", "serve", "train",
                                           "transcribe"]
    for name in want:
        assert got[name] == want[name], name
    top = {a.dest: a.default for a in port._actions}
    assert top["device"] == "cuda" and "platform" not in top


def test_multiprocess_flags_raise(tmp_path):
    """The multi-process flags start a process group (two processes train
    in tests/test_torch_parallel.py); more than one process without a
    coordinator address or a process id raises before any connection."""
    cfg = _config(tmp_path)
    train = _manifest(tmp_path, "train", [0.6])
    for flags in (["--coordinator-address", "localhost:1234",
                   "--num-processes", "2"],
                  ["--num-processes", "2"],
                  ["--num-processes", "2", "--process-id", "0"]):
        with pytest.raises(ValueError, match="coordinator_address and "
                                             "process_id"):
            cli.main(["--device", "cpu", "train", "--config", cfg,
                      "--train-manifest", train,
                      "--work-dir", str(tmp_path / "w"), *flags])


def test_empty_checkpoint_dir_raises(tmp_path):
    cfg = _config(tmp_path)
    evalm = _manifest(tmp_path, "eval", [0.8])
    os.makedirs(tmp_path / "none")
    with pytest.raises(FileNotFoundError):
        cli.main(["--device", "cpu", "eval", "--config", cfg,
                  "--checkpoint-dir", str(tmp_path / "none"),
                  "--manifest", evalm])
