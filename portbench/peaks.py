"""The yardstick's arithmetic: the H100's published peaks, the roofline
bound of the attention kernels, and the algorithmic FLOP counts behind
`mfu.*`.

Frozen with the benchmark: the peaks, `roofline`, `attention_bound` and
`attention_bwd_bound` are copies of `chip_smoke.py`'s (same formulas).
The FLOP counts are the algorithm's, not the program's: 2*m*n*k for each
matmul the model needs, attention over the (q, k) pairs its mask keeps
(half of them, plus the diagonal, for a causal model), no recomputed
work, GPT-2's head over the published vocabulary (50257 rows, not the
padded 50304) and BERT's MLM head over the masked positions only.
"""

from __future__ import annotations

# H100 SXM, NVIDIA data sheet, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12    # tensor cores, bf16 and fp16
PEAK_F32_FLOPS = 67e12      # CUDA cores, float32
PEAK_BYTES = 3.35e12        # HBM3

_ELT = {"float32": 4, "bfloat16": 2, "float16": 2}


def roofline(nbytes: float, flops: float, dtype: str):
    """(seconds, "bytes" or "operations"): the larger of the bytes over
    HBM bandwidth and the FLOPs over the peak rate of the units the
    kernels use for `dtype`."""
    peak = PEAK_F32_FLOPS if dtype == "float32" else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def _pairs(t: int, causal: bool) -> float:
    return t * (t + 1) / 2 if causal else float(t * t)


def attention_bound(b, t, h, h_kv, d, dtype, causal):
    """Least seconds of one forward attention call: q, k, v read once,
    O and lse written once; QK^T and PV over the kept (q, k) pairs."""
    elt = _ELT[dtype]
    nbytes = (2 * b * t * h * d + 2 * b * t * h_kv * d) * elt + b * h * t * 4
    return roofline(nbytes, 4.0 * b * h * d * _pairs(t, causal), dtype)


def attention_bwd_bound(b, t, h, h_kv, d, dtype, causal):
    """Least seconds of one backward attention call: q, k, v, dO, lse and
    delta read once, dq, dk, dv written once; 10 * D FLOPs per head and
    kept pair (QK^T, dO V^T, dS K, dS^T Q, P^T dO)."""
    elt = _ELT[dtype]
    nbytes = (3 * b * t * h * d + 4 * b * t * h_kv * d) * elt \
        + 2 * b * h * t * 4
    return roofline(nbytes, 10.0 * b * h * d * _pairs(t, causal), dtype)


def block_matmul_flops(d_model: int, d_ff: int) -> float:
    """Forward FLOPs of one token through one block's projections: QKV,
    attention out, MLP up and down."""
    return 2.0 * (d_model * 3 * d_model + d_model * d_model
                  + 2 * d_model * d_ff)


def train_flops(shape: dict, batch: int, seq: int, causal: bool,
                head_rows: float) -> float:
    """FLOPs of one training step (forward + backward = 3 x forward) of
    `batch` sequences of `seq` tokens. `head_rows` is how many positions
    the LM head is applied to in the step (every position for a causal
    LM, the masked ones for MLM)."""
    d, layers, vocab = shape["d_model"], shape["n_layer"], shape["vocab"]
    tokens = batch * seq
    fwd = tokens * layers * block_matmul_flops(d, shape["d_ff"])
    fwd += batch * layers * 4.0 * d * _pairs(seq, causal)
    fwd += head_rows * 2.0 * d * vocab
    return 3.0 * fwd


def serve_flops(shape: dict, prompt: int, cached: int, outputs: int):
    """(prefill FLOPs, FLOPs of each decode step in order) of one greedy
    request: the `prompt - cached` prompt tokens a prefill computes (a
    cached prefix is not recomputed), each attending to its real context,
    then one head row for the first token; then each of the `outputs - 1`
    fed-back tokens through the blocks and the head. Padding rows and
    padded pages are not counted."""
    d, layers, vocab = shape["d_model"], shape["n_layer"], shape["vocab"]
    per_tok = layers * block_matmul_flops(d, shape["d_ff"])
    # token at position i attends to i + 1 keys
    ctx = sum(i + 1 for i in range(cached, prompt))
    prefill = (prompt - cached) * per_tok + layers * 4.0 * d * ctx \
        + 2.0 * d * vocab
    steps = [per_tok + layers * 4.0 * d * (prompt + j + 1) + 2.0 * d * vocab
             for j in range(outputs - 1)]
    return prefill, steps
