"""Snowball English stemmer (Porter2, snowballstem.org).

Counterpart of ``bayesian_bm25_tpu/engine/snowball.py``, copied so the
port never imports the JAX package. Porter2 keeps R1/R2 as suffix
strings that shrink and transform with each edit, as the standard
NLTK/snowball implementation does; classic Porter (1980) differs from it
on a real vocabulary (e.g. 'conditional' -> porter 'condit', snowball
'condition'). ``tests/test_torch_native.py`` holds it, and the C++
version in ``native/bb25_native.cpp``, to the JAX package's.
"""

from __future__ import annotations

_V = "aeiouy"
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_END = "cdeghkmnrt"

# Irregular forms resolved before the algorithm proper (published
# exception lists, inflected variants included).
_SPECIAL = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl",
    "sky": "sky", "news": "news", "howe": "howe", "atlas": "atlas",
    "cosmos": "cosmos", "bias": "bias", "andes": "andes",
    "inning": "inning", "innings": "inning",
    "outing": "outing", "outings": "outing",
    "canning": "canning", "cannings": "canning",
    "herring": "herring", "herrings": "herring",
    "earring": "earring", "earrings": "earring",
    "proceed": "proceed", "proceeds": "proceed",
    "proceeded": "proceed", "proceeding": "proceed",
    "exceed": "exceed", "exceeds": "exceed",
    "exceeded": "exceed", "exceeding": "exceed",
    "succeed": "succeed", "succeeds": "succeed",
    "succeeded": "succeed", "succeeding": "succeed",
}

# Edit kinds (mirroring the snowball runtime's marker arithmetic):
#   ("trunc", k)          -- drop the last k chars of word/R1/R2 alike.
#   ("e1", None)          -- drop 1 char, append "e"; an empty region
#                            stays empty.
#   ("repl", (rep, fb2))  -- replace the whole matched suffix by rep; a
#                            region shorter than the suffix collapses
#                            ("" for R1, fb2 for R2 -- the ate/ive
#                            families leave an "e" residue in R2).
# Tables are ordered exactly as the algorithm's longest-match scan;
# the first endswith match wins (even when its region condition then
# fails -- no fallthrough to shorter suffixes).
_STEP2 = (
    ("ization", "repl", ("ize", "")),
    ("ational", "repl", ("ate", "e")),
    ("fulness", "trunc", 4),
    ("ousness", "repl", ("ous", "")),
    ("iveness", "repl", ("ive", "e")),
    ("tional", "trunc", 2),
    ("biliti", "repl", ("ble", "")),
    ("lessli", "trunc", 2),
    ("entli", "trunc", 2),
    ("ation", "repl", ("ate", "e")),
    ("alism", "repl", ("al", "")),
    ("aliti", "repl", ("al", "")),
    ("ousli", "repl", ("ous", "")),
    ("iviti", "repl", ("ive", "e")),
    ("fulli", "trunc", 2),
    ("enci", "e1", None),
    ("anci", "e1", None),
    ("abli", "e1", None),
    ("izer", "repl", ("ize", "")),
    ("ator", "repl", ("ate", "e")),
    ("alli", "repl", ("al", "")),
    # bli/ogi/li carry extra letter conditions, handled inline below
)
_STEP3 = (
    ("ational", "repl", ("ate", "")),
    ("tional", "trunc", 2),
    ("alize", "trunc", 3),
    ("icate", "repl", ("ic", "")),
    ("iciti", "repl", ("ic", "")),
    # ative (R2-conditioned) handled inline to keep scan order
    ("ical", "repl", ("ic", "")),
    ("ness", "trunc", 4),
    ("ful", "trunc", 3),
)
_STEP4 = ("ement", "ance", "ence", "able", "ible", "ment", "ant", "ent",
          "ism", "ate", "iti", "ous", "ive", "ize", "al", "er", "ic")


def _edit(w: str, r1: str, r2: str, suf: str, kind: str, arg):
    if kind == "trunc":
        return w[:-arg], r1[:-arg], r2[:-arg]
    if kind == "e1":
        return (w[:-1] + "e",
                r1[:-1] + "e" if r1 else "",
                r2[:-1] + "e" if r2 else "")
    rep, fb2 = arg
    n = len(suf)
    return (w[:-n] + rep,
            r1[:-n] + rep if len(r1) >= n else "",
            r2[:-n] + rep if len(r2) >= n else fb2)


def _mark_regions(word: str) -> tuple[str, str]:
    """R1/R2 as suffix strings of the y-marked word. R1 starts after the
    first non-vowel that follows a vowel (gener-/commun-/arsen- special
    cases); R2 repeats the rule inside R1."""
    if word.startswith(("gener", "arsen", "commun")):
        r1 = word[6:] if word.startswith("commun") else word[5:]
        r2 = ""
        for i in range(1, len(r1)):
            if r1[i] not in _V and r1[i - 1] in _V:
                r2 = r1[i + 1:]
                break
        return r1, r2
    r1 = r2 = ""
    for i in range(1, len(word)):
        if word[i] not in _V and word[i - 1] in _V:
            r1 = word[i + 1:]
            break
    for i in range(1, len(r1)):
        if r1[i] not in _V and r1[i - 1] in _V:
            r2 = r1[i + 1:]
            break
    return r1, r2


def snowball_stem(word: str) -> str:
    """Porter2 (Snowball English) stemming of a lowercase word."""
    if len(word) <= 2:
        return word
    sp = _SPECIAL.get(word)
    if sp is not None:
        return sp

    w = (word.replace("’", "'").replace("‘", "'")
             .replace("‛", "'"))
    if w.startswith("'"):
        w = w[1:]

    # Mark consonant-y as Y: word-initial, or following a vowel.
    if w.startswith("y"):
        w = "Y" + w[1:]
    for i in range(1, len(w)):
        if w[i] == "y" and w[i - 1] in _V:
            w = w[:i] + "Y" + w[i + 1:]

    r1, r2 = _mark_regions(w)

    # Step 0: possessive markers.
    for suf in ("'s'", "'s", "'"):
        if w.endswith(suf):
            n = len(suf)
            w, r1, r2 = w[:-n], r1[:-n], r2[:-n]
            break

    # Step 1a: plural endings.
    if w.endswith("sses"):
        w, r1, r2 = w[:-2], r1[:-2], r2[:-2]
    elif w.endswith(("ied", "ies")):
        n = 2 if len(w) > 4 else 1
        w, r1, r2 = w[:-n], r1[:-n], r2[:-n]
    elif w.endswith(("us", "ss")):
        pass
    elif w.endswith("s"):
        if any(c in _V for c in w[:-2]):
            w, r1, r2 = w[:-1], r1[:-1], r2[:-1]

    # Step 1b: -ed/-ing families.
    for suf in ("eedly", "ingly", "edly", "eed", "ing", "ed"):
        if not w.endswith(suf):
            continue
        if suf in ("eed", "eedly"):
            if r1.endswith(suf):
                w, r1, r2 = _edit(w, r1, r2, suf, "repl", ("ee", ""))
        elif any(c in _V for c in w[: -len(suf)]):
            n = len(suf)
            w, r1, r2 = w[:-n], r1[:-n], r2[:-n]
            if w.endswith(("at", "bl", "iz")):
                w += "e"
                r1 += "e"
                # Marker quirk: the e lands in R2 only for words already
                # long enough to have reached it.
                if len(w) > 5 or len(r1) >= 3:
                    r2 += "e"
            elif w.endswith(_DOUBLES):
                w, r1, r2 = w[:-1], r1[:-1], r2[:-1]
            elif r1 == "" and (
                (len(w) >= 3 and w[-1] not in _V and w[-1] not in "wxY"
                 and w[-2] in _V and w[-3] not in _V)
                or (len(w) == 2 and w[0] in _V and w[1] not in _V)
            ):
                # Short word: restore the e (regions stay empty).
                w += "e"
        break

    # Step 1c: terminal y after a consonant.
    if len(w) > 2 and w[-1] in "yY" and w[-2] not in _V:
        w = w[:-1] + "i"
        r1 = r1[:-1] + "i" if r1 else ""
        r2 = r2[:-1] + "i" if r2 else ""

    # Step 2 (longest match; applies only inside R1).
    for suf, kind, arg in _STEP2:
        if w.endswith(suf):
            if r1.endswith(suf):
                w, r1, r2 = _edit(w, r1, r2, suf, kind, arg)
            break
    else:
        if w.endswith("bli"):
            if r1.endswith("bli"):
                w, r1, r2 = _edit(w, r1, r2, "bli", "repl", ("ble", ""))
        elif w.endswith("ogi"):
            if r1.endswith("ogi") and w[-4] == "l":
                w, r1, r2 = w[:-1], r1[:-1], r2[:-1]
        elif w.endswith("li"):
            if r1.endswith("li") and w[-3] in _LI_END:
                w, r1, r2 = w[:-2], r1[:-2], r2[:-2]

    # Step 3 (inside R1; -ative additionally requires R2).
    for suf, kind, arg in _STEP3:
        if w.endswith(suf):
            if r1.endswith(suf):
                w, r1, r2 = _edit(w, r1, r2, suf, kind, arg)
            break
    else:
        if w.endswith("ative") and r1.endswith("ative") \
                and r2.endswith("ative"):
            w, r1, r2 = w[:-5], r1[:-5], r2[:-5]

    # Step 4 (inside R2; -ion only after s/t).
    for suf in _STEP4:
        if w.endswith(suf):
            if r2.endswith(suf):
                n = len(suf)
                w, r1, r2 = w[:-n], r1[:-n], r2[:-n]
            break
    else:
        if w.endswith("ion") and r2.endswith("ion") and w[-4] in "st":
            w, r1, r2 = w[:-3], r1[:-3], r2[:-3]

    # Step 5: residual e/l.
    if r2.endswith("l") and w[-2] == "l":
        w = w[:-1]
    elif r2.endswith("e"):
        w = w[:-1]
    elif r1.endswith("e"):
        # Delete unless preceded by a short syllable.
        if len(w) >= 4 and (w[-2] in _V or w[-2] in "wxY"
                            or w[-3] not in _V or w[-4] in _V):
            w = w[:-1]

    return w.replace("Y", "y")
