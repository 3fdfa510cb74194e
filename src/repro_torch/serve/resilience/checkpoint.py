"""Graceful drain/restore: checkpoint live requests to disk, resume later
(``repro.serve.resilience.checkpoint``, copied; the file format is the
same, so a file written by either package restores in the other).

The drain file captures exactly the HOST-side facts needed to resume a
request mid-generation — prompt, tokens generated so far, sampling
parameters, SLO metadata, and the numpy bit-generator state of its
sampling rng.  Device state (KV pages, dense slots) is deliberately NOT
checkpointed: the engine's recompute-preemption machinery already knows
how to rebuild it.  A restored request re-enters WAITING with its
generated tokens appended to the replay stream (``num_cached = 0``), so
admission replays prompt + outputs through chunked prefill — adopting any
published prompt-prefix pages along the way — and the next sampled token
continues the sequence exactly where the drain cut it.  With greedy
sampling the remaining tokens are therefore identical to what the
original engine would have produced; with temperature sampling the saved
rng state makes the continuation reproducible too.

File format (version 2, durability-hardened)::

    {"version": 2, "crc": <crc32 of body>, "length": <body bytes>}\\n
    {"version": 2,
     "requests": [{"request_id": "...", "prompt": [...],
                   "output_tokens": [...],
                   "sampling": {"max_tokens": ..., "temperature": ...,
                                "eos_token_id": ..., "seed": ...},
                   "priority": 0, "tenant": "default",
                   "ttft_deadline_s": null, "n_preemptions": 0,
                   "rng_state": {...} | null},
                  ...]}

Line one is an integrity header (version + CRC32 + byte length of the
JSON body that follows); the body is the same inspectable JSON document
version 1 was.  Writes are crash-safe end to end: tmp file + ``fsync`` +
atomic ``os.replace``, with the previous checkpoint rotated to
``path + ".prev"`` first — so at every instant the disk holds at least
one complete, verifiable checkpoint.  :func:`load_checkpoint` verifies
length + CRC and falls back to the previous-good file on a corrupt,
truncated, or future-version current file; version-1 files (no header)
stay readable.

Requests are recorded running-first (oldest admission first), then the
waiting queue in order, and restored in the same order — so re-admission
priority survives the round trip.  Restored TTFT deadlines restart from
the new submit time (the old wall-clock is meaningless after a restart);
``max_tokens`` counts TOTAL output tokens including the pre-drain ones.
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.engine.request import Request, SamplingParams

CHECKPOINT_VERSION = 2
PREV_SUFFIX = ".prev"           # previous-good rotation target


def request_record(req: Request,
                   rng: Optional[np.random.Generator] = None) -> dict:
    """The JSON-able resume record for one live request."""
    sp = req.sampling
    return {
        "request_id": req.request_id,
        "prompt": list(req.prompt),
        "output_tokens": list(req.output_tokens),
        "sampling": {"max_tokens": sp.max_tokens,
                     "temperature": sp.temperature,
                     "eos_token_id": sp.eos_token_id,
                     "seed": sp.seed},
        "priority": req.priority,
        "tenant": req.tenant,
        "ttft_deadline_s": req.ttft_deadline_s,
        "n_preemptions": req.n_preemptions,
        # bit-generator state is a plain dict of (big) ints and strings —
        # JSON carries it losslessly, so a temperature>0 continuation
        # draws the exact tokens the undrained engine would have
        "rng_state": None if rng is None else rng.bit_generator.state,
    }


def thaw_request(rec: dict) -> Tuple[Request, Optional[dict]]:
    """Rebuild a WAITING request (outputs pre-appended for replay) and its
    saved rng state from one checkpoint record."""
    req = Request(rec["prompt"],
                  SamplingParams(**rec["sampling"]),
                  request_id=rec["request_id"],
                  priority=rec.get("priority", 0),
                  tenant=rec.get("tenant", "default"),
                  ttft_deadline_s=rec.get("ttft_deadline_s"))
    req.output_tokens = [int(t) for t in rec.get("output_tokens", ())]
    req.n_preemptions = int(rec.get("n_preemptions", 0))
    return req, rec.get("rng_state")


def write_checkpoint(payload: dict, path: str, *, fsync: bool = True) -> None:
    """Durably write ``payload`` as a version-2 checkpoint at ``path``.

    tmp + ``fsync`` + atomic rename, with the current file rotated to
    ``path + ".prev"`` FIRST — so a crash at any instant leaves either the
    new checkpoint, or the previous-good one under ``.prev``, and never a
    torn file a restore could mistake for truth (the CRC header catches
    torn writes that slip past the rename discipline, e.g. injected
    ``checkpoint_corrupt`` faults)."""
    body = json.dumps(payload).encode()
    header = json.dumps({
        "version": int(payload.get("version", CHECKPOINT_VERSION)),
        "crc": zlib.crc32(body) & 0xFFFFFFFF,
        "length": len(body),
    }).encode()
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(header + b"\n" + body)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        if os.path.exists(path):
            os.replace(path, path + PREV_SUFFIX)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _parse_checkpoint(path: str) -> dict:
    """Read + verify ONE checkpoint file (no fallback): length and CRC
    must match the header, the version must be known.  Version-1 files
    (one plain JSON document, no header line) parse unchanged."""
    with open(path, "rb") as f:
        raw = f.read()
    nl = raw.find(b"\n")
    header = None
    if nl != -1:
        try:
            header = json.loads(raw[:nl])
        except ValueError:
            header = None
    if isinstance(header, dict) and "crc" in header:
        body = raw[nl + 1:]
        if len(body) != header.get("length"):
            raise ValueError(
                f"truncated drain checkpoint {path!r}: body is "
                f"{len(body)} bytes, header promised {header.get('length')}")
        if (zlib.crc32(body) & 0xFFFFFFFF) != header.get("crc"):
            raise ValueError(
                f"corrupt drain checkpoint {path!r}: body CRC mismatch")
        version = header.get("version")
        if version != CHECKPOINT_VERSION:
            raise ValueError(
                f"unsupported drain checkpoint version {version!r} "
                f"(expected {CHECKPOINT_VERSION})")
        return json.loads(body)
    # no integrity header: a legacy version-1 file, or garbage
    try:
        payload = json.loads(raw)
    except ValueError as e:
        raise ValueError(f"corrupt drain checkpoint {path!r}: "
                         f"not parseable ({e})") from e
    version = payload.get("version") if isinstance(payload, dict) else None
    if version != 1:
        raise ValueError(f"unsupported drain checkpoint version {version!r} "
                         f"(expected {CHECKPOINT_VERSION})")
    return payload


def load_checkpoint(path: str) -> dict:
    """Load the last GOOD checkpoint at ``path``: the current file when it
    verifies, else the ``.prev`` previous-good rotation; fails closed with
    the current file's error when neither is readable."""
    try:
        return _parse_checkpoint(path)
    except (OSError, ValueError) as primary:
        prev = path + PREV_SUFFIX
        if os.path.exists(prev):
            try:
                return _parse_checkpoint(prev)
            except (OSError, ValueError) as fallback:
                raise ValueError(
                    f"no good drain checkpoint: {path!r} failed "
                    f"({primary}) and previous-good {prev!r} failed "
                    f"({fallback})") from primary
        raise


def checkpoint_requests(engine, path: str, *, fsync: bool = True) -> int:
    """Durably write every live request (running first, then waiting)
    to ``path``; returns the number checkpointed.  Pure read — the caller
    decides whether to also finish the requests (drain) or keep going."""
    recs = [request_record(r, engine._rngs.get(r.request_id))
            for r in (*engine.scheduler.running, *engine.scheduler.waiting)]
    write_checkpoint({"version": CHECKPOINT_VERSION, "requests": recs},
                     path, fsync=fsync)
    return len(recs)


def restore_requests(engine, path: str) -> List[Request]:
    """Resubmit every checkpointed request into ``engine`` (same order the
    drain recorded), restoring sampling rng states; returns the requests.
    The engine replays prompt + prior outputs through chunked prefill and
    continues generating from there.  Falls back to the previous-good
    rotation when the current file is corrupt/truncated/future-version."""
    payload = load_checkpoint(path)
    out: List[Request] = []
    for rec in payload["requests"]:
        req, rng_state = thaw_request(rec)
        engine.submit_request(req)
        if rng_state is not None:
            rng = np.random.default_rng()
            rng.bit_generator.state = rng_state
            engine._rngs[req.request_id] = rng
        out.append(req)
    return out
