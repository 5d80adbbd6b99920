"""JSON-lines manifest reading with key aliasing and duration filtering
(counterpart of vietasr_tpu/audio/manifest.py).

A line takes `audio_filename` or `audio_filepath`, requires `duration`,
and takes `text` or `text_filepath` (NeMo's manifest format); `read_manifest`
filters by duration and optionally sorts by it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from os.path import expanduser
from typing import Iterable, Iterator, List, Optional, Sequence, Union


@dataclass(frozen=True)
class ManifestEntry:
    audio_file: str
    duration: float
    text: str
    offset: Optional[float] = None
    speaker: Optional[str] = None


def _parse_line(line: str, manifest_file: str) -> ManifestEntry:
    item = json.loads(line)
    if "audio_filename" in item:
        audio = item["audio_filename"]
    elif "audio_filepath" in item:
        audio = item["audio_filepath"]
    else:
        raise ValueError(
            f"manifest {manifest_file}: line missing audio file key: {line!r}")
    if "duration" not in item:
        raise ValueError(
            f"manifest {manifest_file}: line missing duration: {line!r}")
    if "text" in item:
        text = item["text"]
    elif "text_filepath" in item:
        with open(expanduser(item["text_filepath"]), "r", encoding="utf-8") as f:
            text = f.read().replace("\n", "")
    else:
        raise ValueError(
            f"manifest {manifest_file}: line missing text key: {line!r}")
    return ManifestEntry(
        audio_file=expanduser(audio),
        duration=float(item["duration"]),
        text=text,
        offset=item.get("offset"),
        speaker=item.get("speaker"),
    )


def iter_manifest(
    manifest_files: Union[str, Sequence[str]],
) -> Iterator[ManifestEntry]:
    if isinstance(manifest_files, str):
        manifest_files = [m for m in manifest_files.split(",") if m]
    for manifest_file in manifest_files:
        with open(expanduser(manifest_file), "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield _parse_line(line, manifest_file)


def read_manifest(
    manifest_files: Union[str, Sequence[str]],
    *,
    min_duration: Optional[float] = None,
    max_duration: Optional[float] = None,
    sort_by_duration: bool = False,
    max_number: Optional[int] = None,
) -> List[ManifestEntry]:
    """Load, filter and optionally sort a manifest.

    Returns the kept entries; filtered duration statistics are available on
    the returned list via `read_manifest.last_filtered_duration` (the
    reference logs the same number, collections.py:128-134).
    """
    kept: List[ManifestEntry] = []
    filtered_duration = 0.0
    for entry in iter_manifest(manifest_files):
        if min_duration is not None and entry.duration < min_duration:
            filtered_duration += entry.duration
            continue
        if max_duration is not None and entry.duration > max_duration:
            filtered_duration += entry.duration
            continue
        kept.append(entry)
        if max_number is not None and len(kept) >= max_number:
            break
    if sort_by_duration:
        kept.sort(key=lambda e: e.duration)
    read_manifest.last_filtered_duration = filtered_duration  # type: ignore
    return kept


def write_manifest(path: str, entries: Iterable[ManifestEntry]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for e in entries:
            rec = {"audio_filepath": e.audio_file, "duration": e.duration,
                   "text": e.text}
            if e.offset is not None:
                rec["offset"] = e.offset
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")
