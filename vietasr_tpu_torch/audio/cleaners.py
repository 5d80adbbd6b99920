"""Text cleaners: number/abbreviation expansion and normalization
(counterpart of vietasr_tpu/audio/cleaners.py).

The reference's cleaners depend on inflect/unidecode; number-to-words is
written out here, and the abbreviation table is the reference's English
set.
"""

from __future__ import annotations

import re
from typing import List

_ONES = ["", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand"),
           (100, "hundred")]

ABBREVIATIONS = {
    "mr": "mister", "mrs": "misess", "dr": "doctor", "st": "saint",
    "co": "company", "jr": "junior", "maj": "major", "gen": "general",
    "drs": "doctors", "rev": "reverend", "lt": "lieutenant",
    "hon": "honorable", "sgt": "sergeant", "capt": "captain",
    "esq": "esquire", "ltd": "limited", "col": "colonel", "ft": "fort",
}


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n] if n else "zero"
    if n < 100:
        tens, ones = divmod(n, 10)
        return _TENS[tens] + (" " + _ONES[ones] if ones else "")
    for scale, name in _SCALES:
        if n >= scale:
            head, rest = divmod(n, scale)
            out = number_to_words(head) + " " + name
            if rest:
                out += " " + number_to_words(rest)
            return out
    return str(n)


def expand_numbers(text: str) -> str:
    def repl(m):
        return number_to_words(int(m.group(0).replace(",", "")))

    return re.sub(r"\d[\d,]*", repl, text)


def expand_abbreviations(text: str) -> str:
    def repl(m):
        word = m.group(1).lower()
        return ABBREVIATIONS.get(word, word)

    return re.sub(r"\b([A-Za-z]+)\.", repl, text)


def clean_text(text: str, *, lowercase: bool = True,
               table: str = "en") -> str:
    """Full EN cleaning pipeline: abbreviations -> numbers -> punctuation
    strip -> whitespace collapse (the reference clean_text shape)."""
    if table == "en":
        text = expand_abbreviations(text)
        text = expand_numbers(text)
    if lowercase:
        text = text.lower()
    text = re.sub(r"[^\w\sàáâãèéêìíòóôõùúýăđĩũơưạảấầẩẫậắằẳẵặẹẻẽếềểễệỉịọỏốồổỗộ"
                  r"ớờởỡợụủứừửữựỳỵỷỹ']", " ", text)
    return " ".join(text.split())


def tokenize_clean(text: str) -> List[str]:
    return clean_text(text).split()
