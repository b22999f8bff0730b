"""Minimal pure-Python/NumPy WFDB reader — the raw-data on-ramp.

The reference declares ``wfdb`` but never imports it (reference
requirements.txt:14); its raw-record preprocessing lives in an external
repo (reference README.md:65). Our ``tools/prepare_data.py`` provides that
conversion in-tree, and this module removes its last optional dependency:
a self-contained reader for the two PhysioNet container formats the ECG
delineation datasets (LUDB, QTDB, ...) ship in, exposing the exact two
call signatures ``prepare_data`` uses — ``rdrecord(path)`` →
``.p_signal``/``.fs`` and ``rdann(path, ext)`` → ``.sample``/``.symbol``.
The installed ``wfdb`` package, when present, takes precedence (see the
import fallback in tools/prepare_data.py).

Formats implemented from the published WFDB spec (header(5), signal(5),
annot(5) man pages):

- **Header (.hea)**: record line ``name nsig fs [nsamp]``; one signal line
  per channel ``file format[xN][:skew][+offset] gain[(baseline)][/units]
  adcres adczero initval cksum bsize desc``.
- **Signal (.dat)**: formats 80 (8-bit offset binary), 16/61 (16-bit
  little/big-endian two's complement), 24/32 (LE two's complement),
  212 (two 12-bit samples packed per 3 bytes — MIT-BIH/QTDB), 310/311
  are not needed by any target dataset and raise. Samples are interleaved
  frame-major across the signals sharing a file; digital values convert
  to physical as ``(d - baseline) / gain`` with the format's invalid-
  sample sentinel mapped to NaN.
- **Annotation (.atr etc.)**: the MIT annotation format — a stream of
  16-bit LE words ``(code << 10) | interval`` with pseudo-annotation
  codes SKIP(59, +4-byte big-word-first interval), NUM(60), SUB(61),
  CHN(62), AUX(63, +padded bytes); code 0 terminates. Codes map to the
  standard symbol table (``'('``/``'p'``/``'N'``/``'t'``/``')'`` ... —
  what delineation masks are built from).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["rdrecord", "rdann", "wrsamp", "wrann", "Record", "Annotation",
           "ANN_SYMBOLS"]

# WFDB annotation code → display symbol (ecgcodes.h / wfdb-python
# ann_label_table). Delineation datasets use 39 '(' onset, 40 ')' offset,
# 24 'p', 27 't', 1 'N' peaks.
ANN_SYMBOLS: Dict[int, str] = {
    1: "N", 2: "L", 3: "R", 4: "a", 5: "V", 6: "F", 7: "J", 8: "A",
    9: "S", 10: "E", 11: "j", 12: "/", 13: "Q", 14: "~", 16: "|",
    18: "s", 19: "T", 20: "*", 21: "D", 22: '"', 23: "=", 24: "p",
    25: "B", 26: "^", 27: "t", 28: "+", 29: "u", 30: "?", 31: "!",
    32: "[", 33: "]", 34: "e", 35: "n", 36: "@", 37: "x", 38: "f",
    39: "(", 40: ")", 41: "r",
}

# invalid-sample sentinel per format (WFDB: the most negative value)
_INVALID = {80: -128, 16: -32768, 61: -32768, 212: -2048,
            24: -(1 << 23), 32: -(1 << 31)}


@dataclass
class _SignalSpec:
    file_name: str
    fmt: int
    samps_per_frame: int
    gain: float
    baseline: int
    adc_zero: int
    name: str


@dataclass
class Record:
    """What ``rdrecord`` returns: mirrors the two attributes
    tools/prepare_data.py consumes from the real package."""

    record_name: str
    fs: float
    n_sig: int
    sig_len: int
    p_signal: np.ndarray  # (sig_len, n_sig) float64, NaN where invalid
    sig_name: List[str] = field(default_factory=list)


@dataclass
class Annotation:
    sample: np.ndarray          # (n_ann,) int64 absolute sample indices
    symbol: List[str]           # display symbols, len n_ann
    num: np.ndarray = None      # per-annotation num field
    subtype: np.ndarray = None
    chan: np.ndarray = None
    aux_note: List[Optional[str]] = None


def _parse_header(hea_path: str):
    """Record line + signal specs. Comment lines (#) and info lines after
    the signal block are ignored, as are the optional base time/date."""
    with open(hea_path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.lstrip().startswith("#")]
    rec_tokens = lines[0].split()
    # name may carry /nseg (multi-segment unsupported) or :fs variants
    name = rec_tokens[0].split("/")[0]
    if "/" in rec_tokens[0]:
        raise NotImplementedError(
            f"{hea_path}: multi-segment records are not supported by the "
            "vendored reader (install the real 'wfdb' package)")
    n_sig = int(rec_tokens[1])
    fs = float(rec_tokens[2].split("/")[0]) if len(rec_tokens) > 2 else 250.0
    sig_len = int(rec_tokens[3]) if len(rec_tokens) > 3 else 0

    specs: List[_SignalSpec] = []
    for ln in lines[1:1 + n_sig]:
        t = ln.split()
        file_name = t[0]
        fmt_field = t[1]
        # format[xN][:skew][+offset]
        fmt_str = fmt_field
        samps_per_frame = 1
        for sep in (":", "+"):
            if sep in fmt_str:
                fmt_str = fmt_str.split(sep)[0]
        if "x" in fmt_str:
            fmt_str, n = fmt_str.split("x")
            samps_per_frame = int(n)
        fmt = int(fmt_str)
        # gain[(baseline)][/units]
        gain, baseline = 200.0, None
        if len(t) > 2:
            g = t[2].split("/")[0]
            if "(" in g:
                g, b = g[:-1].split("(")
                baseline = int(b)
            gain = float(g) if float(g) != 0 else 200.0
        adc_zero = int(t[4]) if len(t) > 4 else 0
        if baseline is None:
            baseline = adc_zero
        desc = " ".join(t[8:]) if len(t) > 8 else f"sig{len(specs)}"
        specs.append(_SignalSpec(file_name, fmt, samps_per_frame,
                                 gain, baseline, adc_zero, desc))
    return name, fs, sig_len, specs


def _decode_dat(raw: bytes, fmt: int, n_values: int) -> np.ndarray:
    """Flat digital sample stream (frame-interleaved) from one .dat."""
    if fmt == 80:
        d = np.frombuffer(raw, dtype=np.uint8).astype(np.int32) - 128
    elif fmt == 16:
        d = np.frombuffer(raw, dtype="<i2").astype(np.int32)
    elif fmt == 61:
        d = np.frombuffer(raw, dtype=">i2").astype(np.int32)
    elif fmt == 24:
        b = np.frombuffer(raw, dtype=np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3).astype(np.int32)
        d = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        d = np.where(d >= (1 << 23), d - (1 << 24), d)
    elif fmt == 32:
        d = np.frombuffer(raw, dtype="<i4").astype(np.int64)
    elif fmt == 212:
        b = np.frombuffer(raw, dtype=np.uint8)
        if len(b) % 3:
            b = np.concatenate([b, np.zeros(3 - len(b) % 3, np.uint8)])
        b = b.reshape(-1, 3).astype(np.int32)
        # byte layout per pair: b0 = low 8 of s0; b1 = high 4 of s1 (<<4)
        # | high 4 of s0; b2 = low 8 of s1 — 12-bit two's complement
        s0 = ((b[:, 1] & 0x0F) << 8) | b[:, 0]
        s1 = ((b[:, 1] & 0xF0) << 4) | b[:, 2]
        s0 = np.where(s0 >= 2048, s0 - 4096, s0)
        s1 = np.where(s1 >= 2048, s1 - 4096, s1)
        d = np.stack([s0, s1], axis=1).reshape(-1)
    else:
        raise NotImplementedError(
            f"WFDB signal format {fmt} is not supported by the vendored "
            "reader (supported: 80, 16, 61, 212, 24, 32)")
    return d[:n_values]


def rdrecord(record_path: str) -> Record:
    """Read ``record_path(.hea)`` + its .dat file(s) → physical signals.

    Matches ``wfdb.rdrecord(path).p_signal/.fs`` for the supported
    formats: (sig_len, n_sig) float64 in physical units, invalid samples
    as NaN.
    """
    base = record_path[:-4] if record_path.endswith(".hea") else record_path
    name, fs, sig_len, specs = _parse_header(base + ".hea")
    rec_dir = os.path.dirname(os.path.abspath(base))

    # signals grouped by the .dat file that stores them, preserving order
    by_file: Dict[str, List[int]] = {}
    for i, s in enumerate(specs):
        by_file.setdefault(s.file_name, []).append(i)

    n_sig = len(specs)
    out = np.full((sig_len if sig_len else 0, n_sig), np.nan, np.float64)
    columns: Dict[int, np.ndarray] = {}
    for file_name, idxs in by_file.items():
        fmts = {specs[i].fmt for i in idxs}
        if len(fmts) > 1:
            raise NotImplementedError(
                f"{file_name}: mixed sample formats in one file")
        fmt = fmts.pop()
        frame_width = sum(specs[i].samps_per_frame for i in idxs)
        with open(os.path.join(rec_dir, file_name), "rb") as f:
            raw = f.read()
        if sig_len:
            n_values = sig_len * frame_width
        else:
            per = {80: 1, 16: 2, 61: 2, 24: 3, 32: 4}.get(fmt)
            n_values = (len(raw) // per if per
                        else (len(raw) * 2) // 3)
            n_values -= n_values % frame_width
        d = _decode_dat(raw, fmt, n_values)
        frames = d.reshape(-1, frame_width)
        col = 0
        for i in idxs:
            spf = specs[i].samps_per_frame
            sig = frames[:, col:col + spf]
            # multi-sample frames average down to the frame rate, like
            # the reference reader's smooth_frames default
            dig = sig.mean(axis=1) if spf > 1 else sig[:, 0].astype(
                np.float64)
            invalid = sig[:, 0] == _INVALID[fmt]
            phys = (dig - specs[i].baseline) / specs[i].gain
            phys[invalid] = np.nan
            columns[i] = phys
            col += spf

    length = sig_len or (min(len(v) for v in columns.values())
                         if columns else 0)
    out = np.full((length, n_sig), np.nan, np.float64)
    for i, v in columns.items():
        out[:, i] = v[:length]
    return Record(record_name=name, fs=fs, n_sig=n_sig, sig_len=length,
                  p_signal=out, sig_name=[s.name for s in specs])


def rdann(record_path: str, extension: str) -> Annotation:
    """Read ``record_path.extension`` (MIT annotation format) →
    absolute sample indices + display symbols, mirroring
    ``wfdb.rdann(path, ext).sample/.symbol``."""
    base = (record_path[:-4] if record_path.endswith(".hea")
            else record_path)
    with open(base + "." + extension, "rb") as f:
        raw = f.read()

    samples: List[int] = []
    symbols: List[str] = []
    nums: List[int] = []
    subs: List[int] = []
    chans: List[int] = []
    auxes: List[Optional[str]] = []

    t = 0
    num = chan = 0
    i = 0
    n = len(raw) - 1
    pending_skip = 0
    while i < n:
        word = struct.unpack_from("<H", raw, i)[0]
        i += 2
        code = word >> 10
        interval = word & 0x3FF
        if word == 0:
            break  # EOF marker
        if code == 59:  # SKIP: 4-byte interval, high 16-bit word first
            hi = struct.unpack_from("<H", raw, i)[0]
            lo = struct.unpack_from("<H", raw, i + 2)[0]
            i += 4
            pending_skip += (hi << 16) | lo
            if pending_skip >= (1 << 31):
                pending_skip -= 1 << 32
        elif code == 60:  # NUM change
            num = interval
            if nums:
                nums[-1] = num
        elif code == 61:  # SUB: subtype of the previous annotation
            if subs:
                subs[-1] = interval if interval < 512 else interval - 1024
        elif code == 62:  # CHN change
            chan = interval
            if chans:
                chans[-1] = chan
        elif code == 63:  # AUX: interval = byte count, padded to even
            count = interval
            aux = raw[i:i + count].decode("latin-1").rstrip("\x00")
            i += count + (count & 1)
            if auxes:
                auxes[-1] = aux
        else:
            t += interval + pending_skip
            pending_skip = 0
            samples.append(t)
            symbols.append(ANN_SYMBOLS.get(code, str(code)))
            nums.append(num)
            subs.append(0)
            chans.append(chan)
            auxes.append(None)

    return Annotation(
        sample=np.asarray(samples, dtype=np.int64),
        symbol=symbols,
        num=np.asarray(nums, dtype=np.int64),
        subtype=np.asarray(subs, dtype=np.int64),
        chan=np.asarray(chans, dtype=np.int64),
        aux_note=auxes,
    )


# --------------------------------------------------------------- writers
# Exact inverses of the readers above, for the two container formats the
# delineation datasets ship in (LUDB fmt 16, QTDB fmt 212). Used to
# synthesize genuine on-disk fixtures so the raw-data on-ramp
# (tools/prepare_data.py → train → infer) can be rehearsed end to end in
# the real format before real data ever arrives; round-tripped against
# the readers in tests/test_wfdb_io.py.

_SYMBOL_CODES: Dict[str, int] = {v: k for k, v in ANN_SYMBOLS.items()}


def _encode_dat(d: np.ndarray, fmt: int) -> bytes:
    """Flat digital sample stream (frame-interleaved) → .dat bytes."""
    if fmt == 16:
        return d.astype("<i2").tobytes()
    if fmt == 212:
        if len(d) % 2:  # pairs pack 3 bytes; pad the stream
            d = np.concatenate([d, np.zeros(1, d.dtype)])
        s = d.reshape(-1, 2).astype(np.int64) & 0xFFF  # 12-bit two's compl.
        b = np.empty((len(s), 3), np.uint8)
        b[:, 0] = s[:, 0] & 0xFF
        b[:, 1] = ((s[:, 0] >> 8) & 0x0F) | (((s[:, 1] >> 8) & 0x0F) << 4)
        b[:, 2] = s[:, 1] & 0xFF
        return b.tobytes()
    raise NotImplementedError(
        f"WFDB signal format {fmt} is not supported by the vendored "
        "writer (supported: 16, 212)")


def wrsamp(
    record_path: str,
    fs: float,
    p_signal: np.ndarray,
    fmt: int = 16,
    gain: float = 200.0,
    adc_zero: int = 0,
    units: str = "mV",
    sig_names: Optional[List[str]] = None,
) -> None:
    """Write ``record_path.hea`` + ``record_path.dat``.

    ``p_signal`` is (sig_len, n_sig) physical values; digitization is
    ``round(p * gain) + baseline`` clipped inside the format's range with
    the invalid-sample sentinel excluded (NaN maps to the sentinel).
    """
    p_signal = np.atleast_2d(np.asarray(p_signal, np.float64))
    if p_signal.shape[0] < p_signal.shape[1]:
        raise ValueError("p_signal must be (sig_len, n_sig)")
    sig_len, n_sig = p_signal.shape
    name = os.path.basename(record_path)
    baseline = adc_zero
    lo, hi = _INVALID[fmt] + 1, -_INVALID[fmt] - 1
    d = np.round(p_signal * gain) + baseline
    invalid = ~np.isfinite(d)
    d = np.clip(np.where(invalid, 0, d), lo, hi).astype(np.int64)
    d = np.where(invalid, _INVALID[fmt], d)

    adcres = {16: 16, 212: 12}[fmt]
    lines = [f"{name} {n_sig} {fs:g} {sig_len}"]
    for i in range(n_sig):
        col = d[:, i]
        cksum = int(np.int16(col.sum() & 0xFFFF))
        desc = (sig_names[i] if sig_names else f"sig{i}")
        lines.append(
            f"{name}.dat {fmt} {gain:g}({baseline})/{units} {adcres} "
            f"{adc_zero} {int(col[0]) if sig_len else 0} {cksum} 0 {desc}")
    with open(record_path + ".hea", "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(record_path + ".dat", "wb") as f:
        f.write(_encode_dat(d.reshape(-1), fmt))  # frame-major interleave


def wrann(
    record_path: str,
    extension: str,
    samples: np.ndarray,
    symbols: List[str],
) -> None:
    """Write ``record_path.extension`` in the MIT annotation format.

    Deltas over the 10-bit interval field go through SKIP(59) words
    (4-byte interval, high 16-bit word first) with the annotation word's
    own interval zero — the exact stream :func:`rdann` decodes.
    """
    samples = np.asarray(samples, dtype=np.int64)
    if not np.all(np.diff(samples) >= 0):
        raise ValueError("annotation samples must be non-decreasing")
    if len(samples) != len(symbols):
        raise ValueError("samples and symbols length mismatch")
    out = bytearray()
    t = 0
    for s, sym in zip(samples, symbols):
        code = _SYMBOL_CODES.get(sym)
        if code is None:
            raise ValueError(f"no WFDB code for symbol {sym!r}")
        delta = int(s) - t
        t = int(s)
        if delta > 0x3FF:
            out += struct.pack("<H", 59 << 10)
            out += struct.pack("<H", (delta >> 16) & 0xFFFF)
            out += struct.pack("<H", delta & 0xFFFF)
            delta = 0
        word = (code << 10) | delta
        if word == 0:  # code 0 + interval 0 would read as EOF
            raise ValueError(f"unencodable annotation {sym!r} at delta 0")
        out += struct.pack("<H", word)
    out += struct.pack("<H", 0)  # EOF marker
    with open(record_path + "." + extension, "wb") as f:
        f.write(bytes(out))
