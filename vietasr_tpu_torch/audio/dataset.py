"""Manifest datasets and the static-shape bucketing batcher (counterpart of
vietasr_tpu/audio/dataset.py): audio + transcript, audio + class label
(models/classifier.py) and tokenized text lines.

The host side stays numpy, as in the JAX package, with the same seeded
`np.random.RandomState` shuffle, so the same manifest and seed give the
same batches bit for bit. Utterances go into a fixed set of duration
buckets and are zero-padded to the bucket's length: a few batch shapes,
each one the featurizer and the encoder see again and again. `shard_id` /
`num_shards` give each process its slice of the shuffled manifest.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from vietasr_tpu_torch.audio.io import read_audio
from vietasr_tpu_torch.audio.manifest import ManifestEntry
from vietasr_tpu_torch.audio.tokenizer import CharTokenizer


@dataclass
class Batch:
    """One static-shape batch. `signal` is zero-padded to the bucket length;
    real lengths ride along for masking (never recomputed downstream)."""

    signal: np.ndarray        # (B, S_bucket) float32
    signal_lens: np.ndarray   # (B,) int32
    tokens: np.ndarray        # (B, L_max) int32
    token_lens: np.ndarray    # (B,) int32

    @property
    def audio_seconds(self) -> float:
        return float(self.signal_lens.sum())


class AudioTextDataset:
    """Decodes and tokenizes manifest entries on demand."""

    def __init__(
        self,
        entries: Sequence[ManifestEntry],
        tokenizer: CharTokenizer,
        *,
        sample_rate: int = 16000,
        trim: bool = False,
        augmentor=None,
    ):
        self.tokenizer = tokenizer
        self.sample_rate = sample_rate
        self.trim = trim
        self.augmentor = augmentor
        # tokenize up front; drop utterances with unmappable chars, counted
        self.entries: List[ManifestEntry] = []
        self.token_ids: List[List[int]] = []
        self.num_dropped = 0
        for e in entries:
            ids = tokenizer.encode(e.text)
            if ids is None or len(ids) == 0:
                self.num_dropped += 1
                continue
            self.entries.append(e)
            self.token_ids.append(ids)

    def __len__(self) -> int:
        return len(self.entries)

    def max_token_len(self) -> int:
        return max((len(t) for t in self.token_ids), default=1)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, List[int]]:
        e = self.entries[i]
        samples, _ = read_audio(
            e.audio_file, target_sr=self.sample_rate,
            offset=e.offset or 0.0, duration=e.duration, trim=self.trim)
        if self.augmentor is not None:
            samples = self.augmentor(samples, self.sample_rate)
        return samples.astype(np.float32), self.token_ids[i]


def default_buckets(max_duration: float, sample_rate: int,
                    n_buckets: int = 8) -> List[int]:
    """Geometric-ish bucket upper bounds in samples, last = max_duration."""
    secs = np.linspace(max_duration / n_buckets, max_duration, n_buckets)
    return [int(round(s * sample_rate)) for s in secs]


def pad_to_bucket(x: np.ndarray, bucket_len: int) -> np.ndarray:
    if len(x) >= bucket_len:
        return x[:bucket_len]
    return np.pad(x, (0, bucket_len - len(x)))


class BucketBatcher:
    """Yields static-shape Batches grouped by duration bucket.

    Each epoch: shuffle entries (seeded), assign to buckets, emit batches
    bucket-by-bucket (interleaved in shuffled order). Partial batches are
    padded by repeating the last utterance with zero weight via
    signal_lens=0 when drop_last=False, or dropped when True.
    """

    def __init__(
        self,
        dataset: AudioTextDataset,
        batch_size: int,
        *,
        buckets: Optional[Sequence[int]] = None,
        max_duration: float = 16.7,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        shard_id: int = 0,
        num_shards: int = 1,
        max_token_len: Optional[int] = None,
        bucket_margin: float = 1.0,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.buckets = sorted(buckets or default_buckets(
            max_duration, dataset.sample_rate))
        # with on-the-fly speed perturbation a waveform can come back up to
        # 1/min_speed_rate longer than its manifest duration; margin > 1
        # assigns buckets (and sizes them) for the worst case so the
        # augmented signal is never cropped against its transcript
        self.bucket_margin = float(bucket_margin)
        if self.bucket_margin > 1.0:
            self.buckets = [int(math.ceil(b * self.bucket_margin))
                            for b in self.buckets]
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.max_token_len = max_token_len or dataset.max_token_len()
        self.epoch = 0

    def _bucket_of(self, n_samples: int) -> int:
        # compare the worst-case POST-augmentation length against the
        # (already margin-scaled) bucket bounds, so assignment stays safe
        # for an utterance that lands near a boundary
        n = int(math.ceil(n_samples * self.bucket_margin))
        for bi, b in enumerate(self.buckets):
            if n <= b:
                return bi
        return -1          # longer than the largest bucket

    def steps_per_epoch(self) -> int:
        """Batches one epoch of this shard yields, computed analytically
        from manifest durations (no audio IO). Exact for num_shards=1.
        For num_shards>1 it is APPROXIMATE per epoch: __iter__ shards by
        idx[shard_id::num_shards] AFTER a global shuffle, so a shard's
        per-bucket composition is random and its actual batch count can
        deviate from the even-split estimate here by a few batches in
        either direction (e.g. 2 shards over bucket counts 10/10 at
        bs=4: estimate 6, a 7/3 shuffle split yields 5). Every shard
        runs the same schedule, so only cosine-length sizing is
        affected, and schedules clamp at their floor past the estimate.
        LR schedules need this: len(ds)//batch_size
        undercounts whenever bucketing splits an epoch into more,
        smaller batches (a 13-utterance corpus in 3 buckets yields 3
        batches/epoch, not 1 — so a cosine schedule sized from the
        naive count hit lr=0 a third of the way into training)."""
        counts = [0] * len(self.buckets)
        for e in self.ds.entries:
            bi = self._bucket_of(int(e.duration * self.ds.sample_rate))
            if bi >= 0:
                counts[bi] += 1
        steps = 0
        for c in counts:
            c = c // self.num_shards + (1 if c % self.num_shards else 0)
            if self.drop_last:
                steps += c // self.batch_size
            else:
                steps += (c + self.batch_size - 1) // self.batch_size
        return steps

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.RandomState(self.seed + self.epoch)
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(idx)
        idx = idx[self.shard_id :: self.num_shards]

        self.num_skipped_too_long = 0
        pending: List[List[int]] = [[] for _ in self.buckets]
        for i in idx:
            n = int(self.ds.entries[i].duration * self.ds.sample_rate)
            bi = self._bucket_of(n)
            if bi < 0:
                # truncating audio while keeping the full transcript would
                # create mismatched (and possibly CTC-infeasible) pairs —
                # drop instead, like the reference's max_duration filter
                self.num_skipped_too_long += 1
                continue
            pending[bi].append(int(i))
            if len(pending[bi]) == self.batch_size:
                yield self._make_batch(pending[bi], bi)
                pending[bi] = []
        if not self.drop_last:
            for bi, rest in enumerate(pending):
                if rest:
                    yield self._make_batch(rest, bi, pad_batch=True)
        self.epoch += 1

    def _make_batch(self, indices: List[int], bucket_idx: int,
                    pad_batch: bool = False, rows: Optional[int] = None
                    ) -> Batch:
        bucket_len = self.buckets[bucket_idx]
        b = rows or (self.batch_size if pad_batch else len(indices))
        signal = np.zeros((b, bucket_len), np.float32)
        signal_lens = np.zeros((b,), np.int32)
        tokens = np.zeros((b, self.max_token_len), np.int32)
        token_lens = np.zeros((b,), np.int32)
        for row, i in enumerate(indices):
            samples, ids = self.ds[i]
            n = min(len(samples), bucket_len)
            signal[row, :n] = samples[:n]
            signal_lens[row] = n
            l = min(len(ids), self.max_token_len)
            tokens[row, :l] = ids[:l]
            token_lens[row] = l
        # rows beyond len(indices) stay zero-length -> masked out downstream
        return Batch(signal, signal_lens, tokens, token_lens)


class RankBatcher(BucketBatcher):
    """One rank's share of a data-parallel run's global batches.

    Every rank plans the same epoch: BucketBatcher's shuffle, bucketing
    and padding at the global batch size `batch_size` x `num_ranks`. Rank
    r reads (and augments) only rows [r * batch_size, (r + 1) *
    batch_size) of each global batch, zero-length rows past the global
    batch's end included. So every rank yields the same number of batches
    in the same buckets, and the union of the ranks' rows at step i is the
    one-process BucketBatcher's batch i at the global batch size. (The
    `shard_id` / `num_shards` of BucketBatcher shard the indices before
    bucketing, so its shards' batch counts and buckets differ.)"""

    def __init__(self, dataset: AudioTextDataset, batch_size: int, *,
                 rank: int, num_ranks: int, **kwargs):
        super().__init__(dataset, batch_size * num_ranks, **kwargs)
        self.local_batch = batch_size
        self.rank = rank

    def _make_batch(self, indices: List[int], bucket_idx: int,
                    pad_batch: bool = False, rows: Optional[int] = None
                    ) -> Batch:
        lo = self.rank * self.local_batch
        return super()._make_batch(indices[lo: lo + self.local_batch],
                                   bucket_idx, rows=self.local_batch)


class AudioLabelDataset:
    """Audio + one class label (speech commands, language ID). A manifest
    entry's text, stripped, names its label; entries whose label is not in
    `labels` are dropped and counted in `num_dropped`."""

    def __init__(self, entries: Sequence[ManifestEntry],
                 labels: Sequence[str], *, sample_rate: int = 16000,
                 trim: bool = False, augmentor=None):
        self.labels = list(labels)
        self.label2id = {l: i for i, l in enumerate(self.labels)}
        self.sample_rate = sample_rate
        self.trim = trim
        self.augmentor = augmentor
        self.entries: List[ManifestEntry] = []
        self.label_ids: List[int] = []
        self.num_dropped = 0
        for e in entries:
            lid = self.label2id.get(e.text.strip())
            if lid is None:
                self.num_dropped += 1
                continue
            self.entries.append(e)
            self.label_ids.append(lid)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        e = self.entries[i]
        samples, _ = read_audio(
            e.audio_file, target_sr=self.sample_rate,
            offset=e.offset or 0.0, duration=e.duration, trim=self.trim)
        if self.augmentor is not None:
            samples = self.augmentor(samples, self.sample_rate)
        return samples.astype(np.float32), self.label_ids[i]


class TranscriptDataset:
    """Tokenized text lines, one item a line (empty lines skipped), with
    `bos_id` / `eos_id` prepended / appended when given."""

    def __init__(self, path: str, tokenizer: CharTokenizer, *,
                 bos_id: Optional[int] = None,
                 eos_id: Optional[int] = None):
        self.items: List[List[int]] = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                ids = tokenizer.encode(line.strip())
                if not ids:
                    continue
                if bos_id is not None:
                    ids = [bos_id] + ids
                if eos_id is not None:
                    ids = ids + [eos_id]
                self.items.append(ids)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> List[int]:
        return self.items[i]


def batch_sample_stats(batcher: BucketBatcher) -> dict:
    """Padding-efficiency diagnostics (fraction of real audio in batches)."""
    total = 0
    real = 0
    for batch in batcher:
        total += batch.signal.size
        real += int(batch.signal_lens.sum())
    return {"pad_efficiency": real / max(total, 1)}
