"""Tokenization for the raw-text entry points.

Counterpart of ``bayesian_bm25_tpu/engine/tokenize.py``, copied so the
port never imports the JAX package: lowercase, alphanumeric word
extraction, English stopword removal, and the classic Porter stemmer
(or Porter2, ``engine/snowball.py``). The C++ tokenizer in
``native/bb25_native.cpp`` behaves identically and is used when built
(``engine/native.py``); this Python version is the behavioural
reference and the fallback.
"""

from __future__ import annotations

import re

_WORD_RE = re.compile(r"[a-z0-9]+")

# The classic English stopword list used by bm25s/lucene-style pipelines.
STOPWORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)


# ---------------------------------------------------------------------------
# Porter stemmer (M.F. Porter, 1980) — standard algorithm, self-contained.
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_consonant(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_consonant(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences (the 'm' of the Porter paper)."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        if _is_consonant(stem, i):
            if prev_vowel:
                m += 1
            prev_vowel = False
        else:
            prev_vowel = True
    return m


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _is_consonant(word, len(word) - 1)
    )


def _ends_cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    if not (
        _is_consonant(word, len(word) - 3)
        and not _is_consonant(word, len(word) - 2)
        and _is_consonant(word, len(word) - 1)
    ):
        return False
    return word[-1] not in "wxy"


def porter_stem(word: str) -> str:
    """Porter stemming algorithm (steps 1a-5b)."""
    if len(word) <= 2:
        return word
    w = word

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _contains_vowel(w[:-2]):
            w = w[:-2]
            flag = True
        elif w.endswith("ing") and _contains_vowel(w[:-3]):
            w = w[:-3]
            flag = True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_consonant(w) and not w.endswith(("l", "s", "z")):
                w = w[:-1]
            elif _measure(w) == 1 and _ends_cvc(w):
                w += "e"

    # Step 1c
    if w.endswith("y") and _contains_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2
    step2 = (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
        ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
        ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
        ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
        ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
        ("iviti", "ive"), ("biliti", "ble"),
    )
    for suf, rep in step2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 3
    step3 = (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    )
    for suf, rep in step3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 4
    step4 = (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    )
    for suf in step4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st":
            if _measure(w[:-3]) > 1:
                w = w[:-3]

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem

    # Step 5b
    if _measure(w) > 1 and _ends_double_consonant(w) and w.endswith("l"):
        w = w[:-1]

    return w


# stem option -> native mode int (the C ABI's stem parameter).
_STEM_MODES = {False: 0, True: 1, "none": 0, "porter": 1, "snowball": 2}


def stem_mode(stem: bool | str) -> int:
    """Normalize a ``stem`` option (bool, or "none"/"porter"/"snowball")
    to the integer mode shared with the C++ tokenizer (0/1/2).

    "snowball" is Porter2 — what the reference's BEIR harness uses
    (reference benchmarks/hybrid_beir.py:288-296); plain ``True`` keeps
    the classic-Porter default for backward compatibility.
    """
    try:
        return _STEM_MODES[stem]
    except (KeyError, TypeError):
        raise ValueError(
            f"stem must be a bool or one of 'none'/'porter'/'snowball', "
            f"got {stem!r}"
        ) from None


def _stem_fn(stem: bool | str):
    mode = stem_mode(stem)
    if mode == 1:
        return porter_stem
    if mode == 2:
        from bayesian_bm25_tpu_torch.engine.snowball import snowball_stem

        return snowball_stem
    return None


def tokenize_py(
    text: str,
    *,
    lowercase: bool = True,
    remove_stopwords: bool = True,
    stem: bool | str = True,
) -> list[str]:
    """Pure-Python tokenization pipeline (behavioral reference)."""
    if lowercase:
        text = text.lower()
    tokens = _WORD_RE.findall(text)
    if remove_stopwords:
        tokens = [t for t in tokens if t not in STOPWORDS]
    fn = _stem_fn(stem)
    if fn is not None:
        tokens = [fn(t) for t in tokens]
    return tokens


def tokenize_texts(
    texts: list[str],
    *,
    lowercase: bool = True,
    remove_stopwords: bool = True,
    stem: bool | str = True,
    use_native: bool | str = "auto",
) -> list[list[str]]:
    """Tokenize a batch of texts, preferring the C++ pipeline when built.

    ``stem`` accepts a bool (True = classic Porter) or a stemmer name:
    "none", "porter", or "snowball" (Porter2). With ``use_native`` "auto"
    a library that cannot be built or loaded falls back to the Python
    pipeline (counted in ``native.fallbacks["tokenize"]``); True raises
    instead, False never tries the library.
    """
    if use_native == "auto" or use_native is True:
        from bayesian_bm25_tpu_torch.engine import native

        try:
            return native.tokenize_texts_native(
                texts, lowercase=lowercase,
                remove_stopwords=remove_stopwords, stem=stem,
            )
        except (ImportError, OSError):
            if use_native is True:
                raise
            native.fallbacks["tokenize"] += 1
    return [
        tokenize_py(t, lowercase=lowercase,
                    remove_stopwords=remove_stopwords, stem=stem)
        for t in texts
    ]
