"""paddle_tpu_torch.serving.kvtransfer — portable KV-block snapshots, the
transfer primitive behind disaggregated prefill/decode serving.

The port's counterpart of paddle_tpu/serving/kvtransfer.py. A
`KVSnapshot` is a host container holding ONE request's paged-KV state:
the per-layer block contents for exactly the blocks the request's chain
has written (one gather on the device, one copy to the host — never the
whole pool), the int8 scale-pool entries for those blocks when the
source batcher quantizes its KV, the token ids that produced them, and a
model-shape fingerprint so an import into an incompatible batcher fails
fast instead of producing garbage KV.

Three consumers share it, as in the JAX package: a prefill-role engine's
surrender (the Router migrates the snapshot to a decode replica, which
resumes with zero prefill chunks), the quarantine's slot-in-place
restore and failover attachment, and the supervisor's
drain-export-respawn-resume.

Host-side numpy only: this module imports neither torch nor the JAX
package. numpy has no bfloat16, so a bf16 pool's blocks travel as
`uint16` arrays holding the bf16 bit patterns (`pool_dtype` "bfloat16"
in the fingerprint says how to read them); every other pool dtype
travels as itself. The fingerprint names dtypes as the JAX package does
("bfloat16", "float32", "int8"), so a snapshot crosses between the two
packages: a JAX snapshot's `ml_dtypes` bf16 array is read through
`.view(np.uint16)`, which needs no import of `ml_dtypes`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["KVSnapshot", "check_compatible", "FINGERPRINT_KEYS",
           "host_bits"]

#: fingerprint keys that must match between the exporting and importing
#: batcher — each guards a distinct way an import could silently corrupt
#: the destination pool (shape mismatch, code/scale misinterpretation,
#: block-boundary drift).
FINGERPRINT_KEYS = (
    "num_layers", "num_key_value_heads", "head_dim",
    "block_size", "kv_dtype", "pool_dtype",
)


def host_bits(arr, pool_dtype: str) -> np.ndarray:
    """A snapshot's block array as the numpy array the port imports: the
    `uint16` bit patterns for a "bfloat16" pool (a JAX snapshot's
    `ml_dtypes` array is viewed, not converted), the array itself
    otherwise."""
    a = np.asarray(arr)
    if pool_dtype == "bfloat16" and a.dtype != np.uint16:
        if a.dtype.itemsize != 2:
            raise ValueError(
                f"a bfloat16 pool's blocks must be 2-byte values, got "
                f"{a.dtype}")
        a = a.view(np.uint16)
    return a


@dataclass
class KVSnapshot:
    """One request's portable paged-KV state.

    `k`/`v` are `[L, n_blocks, block_size, KV_heads, head_dim]` host
    arrays of the pool's storage (int8 codes for an int8 pool, bf16 bits
    as uint16 for a bf16 one), in chain order so block i holds tokens
    `[i*block_size, (i+1)*block_size)`. `k_scale`/`v_scale` are the
    matching `[L, n_blocks]` float32 scale-pool entries (None for an fp
    pool); transferring them verbatim keeps the grow-only sentinel
    discipline intact — a 0.0 entry stays "never written".

    `tokens` is the full sequence `prompt + generated`, INCLUDING the
    last emitted token whose KV was never written (decode writes token
    t's KV while producing t+1) — so the written KV length is
    `len(tokens) - 1` and the import resumes decode AT `len(tokens)`.
    `tail_valid` records how many positions of the final block hold real
    KV (`block_size` when the written length is block-aligned).
    """
    k: Any                               # [L, n, bs, KV, hd] host array
    v: Any                               # [L, n, bs, KV, hd] host array
    k_scale: Optional[Any]               # [L, n] f32, or None (fp pool)
    v_scale: Optional[Any]               # [L, n] f32, or None (fp pool)
    tokens: List[int]                    # prompt + generated (see above)
    prompt_len: int                      # len(prompt) within `tokens`
    budget: int                          # remaining emission budget
    stop_token_id: int                   # per-request stop id (-1 = none)
    tail_valid: int                      # valid positions in final block
    fingerprint: Dict[str, Any]          # model/pool-shape compatibility
    src_blocks: List[int] = field(default_factory=list)
    src_replica: str = ""                # exporting replica's id

    @property
    def n_blocks(self) -> int:
        """Blocks this snapshot carries (the chain's written extent)."""
        return int(self.k.shape[1])

    @property
    def nbytes(self) -> int:
        """Host bytes of KV payload (codes + scales) — what a wire
        transport would move; token ids and metadata are not counted."""
        n = int(self.k.nbytes) + int(self.v.nbytes)
        if self.k_scale is not None:
            n += int(self.k_scale.nbytes)
        if self.v_scale is not None:
            n += int(self.v_scale.nbytes)
        return n

    def describe(self) -> Dict[str, Any]:
        """Plain-dict summary for traces/logs (no array payloads)."""
        return {
            "blocks": self.n_blocks, "bytes": self.nbytes,
            "tokens": len(self.tokens), "prompt_len": self.prompt_len,
            "budget": self.budget, "tail_valid": self.tail_valid,
            "kv_dtype": self.fingerprint.get("kv_dtype"),
            "src_replica": self.src_replica,
        }


def check_compatible(snapshot_fp: Dict[str, Any],
                     local_fp: Dict[str, Any]) -> List[str]:
    """Compare a snapshot's fingerprint against the importing batcher's
    — returns a list of human-readable mismatches (empty = compatible).
    The import path raises ValueError listing these, so a topology
    mistake (wrong model, wrong kv_dtype, different block size) fails
    at the handoff boundary, not as silent KV corruption."""
    problems = []
    for key in FINGERPRINT_KEYS:
        a, b = snapshot_fp.get(key), local_fp.get(key)
        if a != b:
            problems.append(f"{key}: snapshot={a!r} local={b!r}")
    return problems
