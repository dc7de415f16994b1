"""Wire format for sealed KV blocks + hash-chain metadata (port of
ray_tpu/serve/kv_tier/codec.py).

One encoded payload carries a contiguous chain of sealed blocks — the
per-block token tuples (enough to rebuild every content-addressed chain
key from the root) and the gathered K/V pool contents.  The decode-side
``PagedKVCache.install_prefix`` adopts the blocks as if it had sealed
them itself, so a prefill→decode handoff is bit-exact by construction
and idempotent on retry.

What the port does differently — bf16.  The reference pickles numpy
arrays of `ml_dtypes.bfloat16`, a type numpy itself lacks; a machine
without `ml_dtypes` cannot unpickle them, and the reference's
`install_prefix` checks only shapes, so raw bf16 bits sent in its v1
frame would be installed there as wrong numbers.  So:

- a pool of a numpy-native dtype (float32) gives exactly the reference's
  v1 frame (magic ``KVT1``, ``v: 1``, the arrays as they are); the two
  packages decode each other's;
- a bf16 pool gives a ``v: 2`` frame with ``dtype: "bfloat16"`` and K/V
  as their uint16 bits.  The reference's decoder refuses any ``v != 1``,
  so such a frame reaching a JAX decode replica is a cache miss and a
  re-prefill there, never a misread;
- decoding, the port reads v2 frames, and v1 frames whose arrays are
  numpy-native or have the dtype name ``bfloat16`` (a JAX bf16 pool's);
  those it turns into the v2 form bit-exactly through a uint16 view,
  without importing ml_dtypes itself (unpickling the frame may).  A
  frame that fails to unpickle (no ml_dtypes, truncation, garbage) is a
  ``KVCodecError``, so a miss for ``try_decode``.
"""

from __future__ import annotations

import io
import pickle
from typing import Optional

import numpy as np

_MAGIC = b"KVT1"
BF16 = "bfloat16"


class KVCodecError(ValueError):
    """Payload is not a KVBlockCodec frame (or an incompatible one)."""


def _bf16_bits(payload: dict) -> dict:
    """A v1 payload with ml_dtypes bfloat16 arrays in the v2 form."""
    return {"v": 2, "dtype": BF16, "block_size": payload["block_size"],
            "chain": payload["chain"],
            "k": payload["k"].view(np.uint16),
            "v_pool": payload["v_pool"].view(np.uint16)}


class KVBlockCodec:
    """Encode/decode ``PagedKVCache.export_prefix`` payloads.

    The frame is a 4-byte magic + a pickled dict whose arrays are plain
    numpy.  The version field gates compatibility (see the module
    docstring); the magic catches whole-payload confusion early (a
    truncated or foreign blob raises KVCodecError, never a
    half-installed cache)."""

    @staticmethod
    def encode(payload: dict) -> bytes:
        v = payload.get("v") if payload else None
        if v not in (1, 2):
            raise KVCodecError("not an export_prefix v1 or v2 payload")
        k, v_pool = (np.ascontiguousarray(payload[n]) for n in ("k", "v_pool"))
        frame = {"v": v, "block_size": int(payload["block_size"]),
                 "chain": [list(map(int, blk)) for blk in payload["chain"]],
                 "k": k, "v_pool": v_pool}
        if v == 2:
            if payload.get("dtype") != BF16 or k.dtype != np.uint16:
                raise KVCodecError("a v2 payload carries bf16 as uint16 bits")
            frame = {"v": 2, "dtype": BF16, **{n: frame[n] for n in (
                "block_size", "chain", "k", "v_pool")}}
        buf = io.BytesIO()
        buf.write(_MAGIC)
        pickle.dump(frame, buf, protocol=pickle.HIGHEST_PROTOCOL)
        return buf.getvalue()

    @staticmethod
    def decode(blob: bytes) -> dict:
        if not isinstance(blob, (bytes, bytearray, memoryview)):
            raise KVCodecError(f"expected bytes, got {type(blob).__name__}")
        blob = bytes(blob)
        if blob[:4] != _MAGIC:
            raise KVCodecError("bad magic: not a KV block frame")
        try:
            payload = pickle.loads(blob[4:])
            k, v = payload["k"], payload["v_pool"]
            n, bs = len(payload["chain"]), payload["block_size"]
            version = payload.get("v")
            if version == 1 and k.dtype.name == BF16:
                payload = _bf16_bits(payload)
                k, v, version = payload["k"], payload["v_pool"], 2
            shapes = (k.shape, v.shape, k.ndim, k.dtype, v.dtype)
        except Exception as exc:
            raise KVCodecError(f"corrupt KV block frame: {exc}") from exc
        if version == 1 and k.dtype.kind != "f":
            raise KVCodecError(f"v1 frame of unsupported dtype {k.dtype}")
        elif version == 2 and (payload.get("dtype") != BF16
                               or k.dtype != np.uint16):
            raise KVCodecError(f"v2 frame of dtype {payload.get('dtype')} "
                               f"with {k.dtype} arrays")
        elif version not in (1, 2):
            raise KVCodecError(f"unknown KV frame version {version}")
        k_shape, v_shape, ndim, k_dtype, v_dtype = shapes
        if k_shape != v_shape or k_dtype != v_dtype or ndim != 5 or \
                k_shape[1] != n or k_shape[2] != bs:
            raise KVCodecError(
                f"frame shape mismatch: k{k.shape} v{v.shape} vs "
                f"{n} chain blocks of size {bs}")
        return payload

    @staticmethod
    def try_decode(blob) -> Optional[dict]:
        """Decode-or-None: the decode path treats a bad handoff as a
        cache miss (re-prefill), never a failed request."""
        try:
            return KVBlockCodec.decode(blob)
        except KVCodecError:
            return None
