"""BED9 export of single-group regime probabilities, in numpy.

Counterpart of hygeia_tpu/pipeline/bed.py, which is written in pandas; the
BED, ``.bed.gz`` and ``.tbi`` files written here are that module's byte
for byte. Each CpG site becomes a BED9 record named after its most
probable regime ("equiprobable" on ties), scored by the maximum
probability, coloured with the fixed 6-regime palette (cycled for R > 6).

The pandas behaviours the output depends on, reproduced: ``read_csv``'s
default float parser (``precise_xstrtod``: up to 17 significant digits,
leading zeros included, accumulated in a double and scaled by one power of
ten, which is not always the correctly rounded value); ``sort_values`` on
two columns is a stable lexsort; ``to_csv`` writes a float64 by its repr
and quotes a field only when it holds the separator, a quote or a newline.
"""

from __future__ import annotations

import csv
import os
import re

import numpy as np

from hygeia_tpu_torch.utils import io as hio

_REGIME_COLOURS = [
    "248,118,109",
    "183,159,0",
    "0,186,56",
    "0,191,196",
    "97,156,255",
    "245,100,227",
]
_TIE_COLOUR = "128,128,128"

_NUMBER = re.compile(r"^\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*$")
_POW10 = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17


def _pandas_float(text):
    """One cell as pandas' read_csv parses a float column (its C parser's
    ``precise_xstrtod``)."""
    m = _NUMBER.match(text)
    if m is None or not (m.group(2) or m.group(3)):
        return float(text) if text.strip() else float("nan")
    sign, whole, frac, exp = m.group(1), m.group(2), m.group(3) or "", m.group(4)
    if len(whole) + len(frac) <= 15 and abs(int(exp or 0) - len(frac)) <= 22:
        # An integer below 2**53 times or over an exact power of ten, one
        # rounding: the correctly rounded value.
        return float(text)
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    decimals = 0
    for ch in frac:
        if digits >= _MAX_DIGITS:
            break
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        decimals += 1
    exponent -= decimals
    if exp is not None:
        exponent += int(exp)
    if exponent > 308:
        number = float("inf")
    elif exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -308:
        number = 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    return -number if sign == "-" else number


def _read_regimes(path):
    """(regime column names, (T, R) probabilities, (T,) positions) of a
    headed regime-probability CSV."""
    rows = [ln.split(",") for ln in hio._read_text(path).decode().splitlines() if ln.strip()]
    header = [h.strip().strip('"') for h in rows[0]]
    body = rows[1:]
    pi = header.index("genomic_position")
    names = [c for c in header if c != "genomic_position"]
    cols = [i for i, c in enumerate(header) if c != "genomic_position"]
    probs = np.array([[_pandas_float(r[i]) for i in cols] for r in body], np.float64)
    probs = probs.reshape(len(body), len(cols))
    pos = np.array([int(_pandas_float(r[pi])) for r in body], np.int64)
    return names, probs, pos


def make_bed(chrom, regimes_file, output_file, *, compress=False):
    """Write the BED9 track; with compress=True bgzip it to
    ``<output_file>.gz`` (removing the plain file) and build the tabix index
    ``<output_file>.gz.tbi``. Returns the rows' order-sorted columns as a
    dict."""
    names, probs, pos = _read_regimes(regimes_file)
    score = probs.max(axis=1)
    ties = (probs == score[:, None]).sum(axis=1) > 1
    best = probs.argmax(axis=1)
    regime = np.where(ties, "equiprobable", np.asarray(names, dtype=object)[best])
    palette = np.asarray([_REGIME_COLOURS[i % len(_REGIME_COLOURS)] for i in range(len(names))])
    colours = np.where(ties, _TIE_COLOUR, palette[best])
    order = np.argsort(pos - 1, kind="stable")  # lexsort on (chr, start); chr is one value
    bed = {
        "chr": np.full(pos.size, str(chrom), dtype=object),
        "start": (pos - 1)[order],
        "end": (pos + 1)[order],
        "name": regime[order],
        "score": score[order],
        "strand": np.full(pos.size, ".", dtype=object),
        "thickStart": (pos - 1)[order],
        "thickEnd": (pos + 1)[order],
        "itemRgb": colours[order],
    }
    out_dir = os.path.dirname(output_file)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    cells = [
        [repr(v) if v == v else "" for v in col.tolist()] if k == "score" else [str(v) for v in col.tolist()]
        for k, col in bed.items()
    ]
    with open(output_file, "w", newline="") as f:
        csv.writer(f, delimiter="\t", lineterminator="\n").writerows(zip(*cells))
    if compress:
        from hygeia_tpu_torch.utils.bgzf import compress_file
        from hygeia_tpu_torch.utils.tabix import build_index

        build_index(compress_file(str(output_file), delete_src=True))
    return bed
