"""Offline batch transcription: one caller with a backlog (a closed loop).
Each call hands `Transcriber.transcribe_batch` the mix's utterances, in an
order drawn from the seed; the next call starts when the last returns.

The window's metric is the audio seconds of every call it completed over
its wall seconds, tracing off. The output check judges a sample of the
window's forwards: a reservoir, drawn from the seed, over the calls the
window completed, one forward of each (one of them the longest bucket's).
What the timed path produced there (the frontend's features, the head's
log-probs, the greedy ids and the transcripts) is held against the plain
reference run once the window has closed.
"""

from __future__ import annotations

import time

import numpy as np

from asrbench import core, synth
from asrbench.drivers import common
from asrbench.trace import Stretch, span


def imports():
    from asrbench.reference import logmel, precision, quartznet  # noqa: F401
    from vietasr_tpu_torch.pipeline import Transcriber  # noqa: F401


def groups(lengths, buckets, max_batch):
    """The forwards of one call, as transcribe_batch forms them: indices
    sorted by length (stable), then up to max_batch of one bucket."""
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    out, i = [], 0
    bucket = lambda n: next(b for b in buckets if n <= b)  # noqa: E731
    while i < len(order):
        bl = bucket(lengths[order[i]])
        g = []
        while (i < len(order) and len(g) < max_batch
               and bucket(lengths[order[i]]) == bl):
            g.append(order[i])
            i += 1
        out.append((bl, g))
    return out


class _Recorder:
    """Wraps the Transcriber's per-forward entry and its featurizer (both
    attributes of the instance) to keep, for the forwards chosen, copies of
    what they produced, and in the traced stretch each forward's shape."""

    def __init__(self, tr):
        self.fwd, self.want = 0, None
        self.cap, self.shapes, self.feats = None, None, None
        fwd, featurize = tr._fwd, tr._featurize

        def _fwd(batch, lens):
            with span("forward"):
                out = fwd(batch, lens)
            if self.fwd == self.want:
                self.cap = {"fwd": self.fwd, "lens": lens.copy(),
                            "feats": self.feats,
                            "out": [o.clone() for o in out]}
            if self.shapes is not None:
                self.shapes.append((batch.shape[0], batch.shape[1],
                                    lens.copy()))
            self.fwd += 1
            return out

        def _featurize(signal, lengths, **kw):
            out = featurize(signal, lengths, **kw)
            if self.fwd == self.want:
                self.feats = [o.clone() for o in out]
            return out

        tr._fwd, tr._featurize = _fwd, _featurize

    def next_call(self, want):
        self.fwd, self.want, self.cap = 0, want, None


def run(ctx):
    import torch
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    cfg, mix = ctx.config, ctx.traffic
    dev = ctx.device
    mark = common.Marks(ctx.t_start)
    mark("start")
    variables = common.variables(cfg, ctx.seed, dev)
    common.sync(dev)
    mark("weights")
    # the controls: "int8" the program's own int8 path (calibrated on the
    # mix's first utterances), "fast" its bf16 frontend; "plain" its blocks
    # through the repeat kernels' plain PyTorch versions (a second witness)
    if ctx.control not in (None, "int8", "fast", "plain"):
        raise SystemExit(f"offline: no control {ctx.control!r}")
    opts = TranscriberOptions(
        max_batch=mix["max_batch"], decoder=mix["decoder"],
        buckets_seconds=tuple(mix["buckets_s"]),
        fused_frontend="fast" if ctx.control == "fast" else "auto",
        block_impl="plain" if ctx.control == "plain" else "auto")
    tr = Transcriber(common.write_yaml(cfg, ctx.tmpdir), variables=variables,
                     options=opts, device=dev)
    mark("program")
    sigs, _ = synth.utterances(ctx.seed, mix["utterances"], mix["min_s"],
                               mix["max_s"], cfg["labels"])
    mark("traffic")
    if ctx.control == "int8":
        tr.calibrate_int8(sigs[:mix["max_batch"]])
    rng = np.random.default_rng([ctx.seed, 1])
    n = len(sigs)
    rec = _Recorder(tr)
    # warm-up: every call has the same shapes, so two calls build and
    # allocate all that the window will use
    t_call = []
    for _ in range(2):
        rec.next_call(None)
        common.sync(dev)
        t0 = time.perf_counter()
        tr.transcribe_batch(sigs)
        common.sync(dev)
        t_call.append(time.perf_counter() - t0)
    forwards = rec.fwd
    mark("warm_calls")
    setup_s = time.perf_counter() - ctx.t_start

    # the sample: a reservoir over the window's calls (Algorithm R, drawn
    # from the seed), each slot one forward of its call, captured as the
    # call runs; slot 0 takes the last forward, the longest bucket
    m = mix["judged_forwards"]
    pick = np.random.default_rng([ctx.seed, 2])
    slot_fwd = [forwards - 1] + pick.integers(forwards, size=m - 1).tolist()
    samples = [None] * m
    stretch, traced = Stretch() if ctx.trace else None, None
    audio = 0.0
    calls, call_s = 0, []

    def close_stretch():
        out = stretch.stop()
        out.update(launches=common.launches_since(launches0),
                   forwards=rec.shapes, audio_s=audio_trace,
                   utterances=calls_trace * n)
        rec.shapes = None
        return out

    t0 = time.perf_counter()
    while True:
        perm = rng.permutation(n)
        if stretch is not None and traced is None and rec.shapes is None \
                and time.perf_counter() - t0 >= ctx.trace_start_s:
            rec.shapes = []
            stretch.start()
            t_trace, audio_trace, calls_trace = time.perf_counter(), 0.0, 0
            launches0 = common.launches()
        slot = calls if calls < m else int(pick.integers(calls + 1))
        slot = slot if slot < m else None
        rec.next_call(None if slot is None else slot_fwd[slot])
        batch = [sigs[i] for i in perm]
        t_c = time.perf_counter()
        with span("call"):
            out = tr.transcribe_batch(batch)
        call_s.append(time.perf_counter() - t_c)
        if slot is not None:
            samples[slot] = dict(rec.cap, perm=perm, texts=out)
        secs = sum(len(s) for s in batch) / synth.SR
        audio += secs
        calls += 1
        if rec.shapes is not None and traced is None:
            audio_trace += secs
            calls_trace += 1
            if time.perf_counter() - t_trace >= ctx.trace_seconds:
                traced = close_stretch()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    common.sync(dev)
    wall = time.perf_counter() - t0
    if rec.shapes is not None:
        traced = close_stretch()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    samples = [c for c in samples if c is not None]
    del tr, rec
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, readings, failed = judge(ctx, variables, sigs, samples)
    return {"metrics": {"audio_s_per_s": audio / wall, "setup_s": setup_s},
            "checks": checks, "attempted": calls * n, "failed": failed,
            "memory_peak_bytes": peak, "trace": traced,
            "info": {"calls": calls, "wall_s": wall,
                     "forwards_per_call": forwards, "judged": len(samples),
                     "call_s_quartiles": np.percentile(
                         call_s, [0, 25, 50, 75, 100]).tolist(),
                     "warm_call_s": t_call, "setup_split": mark.split,
                     "readings": readings}}


def judge(ctx, variables, sigs, caps):
    """Each judged forward against the reference: features over the valid
    frames; over the valid output frames, each frame's largest |d log p|
    and how far below the reference's best the served greedy id lies
    (their largest, 99th percentile and mean over every judged frame); each
    row's largest and mean |d log p| over those of the reference with bf16
    operands on the same row (the largest such ratios); the output
    lengths; each row's transcript against the collapse of its served ids.
    Returns
    (checks {name: [value, limit]} for the numbers the cell's limits name,
    the other numbers, the rows that failed)."""
    import torch
    from asrbench.reference import logmel, precision, quartznet

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    fcfg, blocks, labels = cfg["featurizer"], cfg["blocks"], cfg["labels"]
    blank = len(labels)
    buckets = [int(s * synth.SR) for s in mix["buckets_s"]]
    lim = ctx.limits
    nums = {"features_max_abs": 0.0, "logp_row_max_ratio": 0.0,
            "logp_row_mean_ratio": 0.0, "lens_mismatch": 0,
            "ids_mismatch": 0, "text_mismatch": 0}
    d_frames, gap_frames, b_frames = [], [], []
    judged = failed = 0
    with common.strict_fp32(), torch.no_grad():
        for cap in caps:
            batch = [sigs[i] for i in cap["perm"]]
            bl, rows = groups([len(s) for s in batch], buckets,
                              mix["max_batch"])[cap["fwd"]]
            judged += len(rows)
            sig = np.zeros((len(rows), bl), np.float32)
            lens = np.zeros(len(rows), np.int32)
            for r, i in enumerate(rows):
                sig[r, :len(batch[i])] = batch[i]
                lens[r] = len(batch[i])
            feats, flen = logmel.log_mel(torch.from_numpy(sig).to(dev),
                                         torch.from_numpy(lens).to(dev), fcfg)
            lp, elen = quartznet.forward(variables, feats, flen, blocks)
            lp16, _ = quartznet.forward(variables, feats, flen, blocks,
                                        quant=precision.bf16)
            pf, pflen = cap["feats"]
            plp, pel, preds, _ = cap["out"]
            if (not np.array_equal(lens, cap["lens"])
                    or pf.shape != feats.shape or plp.shape != lp.shape):
                nums["lens_mismatch"] += len(rows)
                failed += len(rows)
                continue
            row_bad = ((pflen.to(flen.dtype) != flen)
                       | (pel.to(elen.dtype) != elen)).cpu().numpy()
            nums["lens_mismatch"] += int(row_bad.sum())
            fmask = (torch.arange(feats.shape[1], device=dev)[None, :]
                     < flen[:, None])[..., None]
            d_feat = ((pf - feats).abs() * fmask).amax(dim=(1, 2))
            nums["features_max_abs"] = max(nums["features_max_abs"],
                                           float(d_feat.max()))
            vmask = (torch.arange(lp.shape[1], device=dev)[None, :]
                     < elen[:, None])
            # the decoder judged on what it was given: each served id the
            # argmax (first of ties) of the served log-probs
            bad_ids = (preds.long() != plp.argmax(dim=-1)) & vmask
            nums["ids_mismatch"] += int(bad_ids.sum())
            row_bad |= bad_ids.any(dim=1).cpu().numpy()
            d = (plp.float() - lp).abs().amax(dim=-1)
            served = lp.gather(-1, preds.long()[..., None])[..., 0]
            gap = lp.amax(dim=-1) - served
            d_frames.append(d[vmask])
            gap_frames.append(gap[vmask])
            b = (lp16 - lp).abs().amax(dim=-1)
            b_frames.append(b[vmask])
            # each row against the bf16 reference's own error on that row:
            # its largest, and its mean over the row's frames
            tiny = torch.finfo(b.dtype).tiny
            row_max = (d * vmask).amax(dim=1) / (b * vmask).amax(
                dim=1).clamp_min(tiny)
            row_mean = (d * vmask).sum(dim=1) / (b * vmask).sum(
                dim=1).clamp_min(tiny)
            for name, per_row in (("logp_row_max_ratio", row_max),
                                  ("logp_row_mean_ratio", row_mean)):
                nums[name] = max(nums[name], float(per_row.max()))
            for name, per_row in (
                    ("features_max_abs", d_feat),
                    ("logp_max_abs", (d * vmask).amax(dim=1)),
                    ("served_gap", (gap * vmask).amax(dim=1)),
                    ("logp_row_max_ratio", row_max),
                    ("logp_row_mean_ratio", row_mean)):
                if name in lim:
                    row_bad |= (per_row > lim[name]).cpu().numpy()
            p_np, el_np = preds.cpu().numpy(), elen.cpu().numpy()
            for r, i in enumerate(rows):
                ids = [int(p) for t, p in enumerate(p_np[r][:el_np[r]])
                       if p != blank and (t == 0 or p != p_np[r][t - 1])]
                if cap["texts"][i] != "".join(labels[k] for k in ids):
                    nums["text_mismatch"] += 1
                    row_bad[r] = True
            failed += int(row_bad.sum())
        if d_frames:
            for name, frames in (("logp", torch.cat(d_frames)),
                                 ("served_gap", torch.cat(gap_frames))):
                stem = "logp_max_abs" if name == "logp" else "served_gap"
                nums[stem] = float(frames.max())
                nums[name + ("_p99_abs" if name == "logp" else "_p99")] = \
                    float(torch.quantile(frames.double(), 0.99))
                nums[name + ("_mean_abs" if name == "logp" else "_mean")] = \
                    float(frames.double().mean())
            ref16 = torch.cat(b_frames).double()
            nums["logp_mean_ratio"] = nums["logp_mean_abs"] / float(
                ref16.mean())
            nums["logp_p99_ratio"] = nums["logp_p99_abs"] / float(
                torch.quantile(ref16, 0.99))
    checks = {k: [nums[k], lim[k]] for k in lim}
    if not core.checks_ok(checks) and not failed:
        failed = judged          # a number over all judged frames failed
    return checks, {k: v for k, v in nums.items() if k not in lim}, failed
