"""Character tokenizer with multi-character "special label" support (the
port's copy of vietasr_tpu/audio/tokenizer.py).

Reference: NeMo's CharParser (nemo/collections/asr/parts/parsers.py) —
lowercases (optionally), maps characters to label ids, supports labels
longer than one char by greedy longest-match, and drops utterances
containing unknown characters unless unk is mapped.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class CharTokenizer:
    def __init__(
        self,
        labels: Sequence[str],
        *,
        unk_id: int = -1,
        blank_id: int = -1,
        do_lowercase: bool = True,
    ):
        self.labels = list(labels)
        self.unk_id = unk_id
        self.blank_id = blank_id
        self.do_lowercase = do_lowercase
        self._label_to_id = {l: i for i, l in enumerate(self.labels)
                             if i not in (unk_id, blank_id)}
        self._special = sorted(
            (l for l in self._label_to_id if len(l) > 1),
            key=len, reverse=True)

    @property
    def vocab_size(self) -> int:
        return len(self.labels)

    def encode(self, text: str) -> Optional[List[int]]:
        """Returns label ids, or None if the text contains unmappable chars
        and no unk is configured (the reference drops such utterances)."""
        if self.do_lowercase:
            text = text.lower()
        ids: List[int] = []
        i = 0
        while i < len(text):
            matched = False
            for sp in self._special:
                if text.startswith(sp, i):
                    ids.append(self._label_to_id[sp])
                    i += len(sp)
                    matched = True
                    break
            if matched:
                continue
            ch = text[i]
            if ch in self._label_to_id:
                ids.append(self._label_to_id[ch])
            elif self.unk_id >= 0:
                ids.append(self.unk_id)
            else:
                return None
            i += 1
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.labels[i] for i in ids
                       if 0 <= i < len(self.labels) and i != self.blank_id)
