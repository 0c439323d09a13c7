"""The yardstick's arithmetic, frozen inside the benchmark: the H100's
published peaks, the least time the card could take for a kernel call or a
decode step, and the model FLOPs of a train step or a prefill.

Copied from ``chip_smoke.py`` (``PEAK_*``, ``_attn_pairs``,
``flash_bounds``, the fused scan's byte and operation counts of
``fused_cases`` and ``fused_train_cases``, ``_model_flops``) so that a later
change to that script cannot move what the benchmark measures against.  The
functions take plain numbers, never a program object, and import nothing.
"""

from __future__ import annotations

#: published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_TC_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def attn_pairs(Sq: int, Skv: int, causal: bool = True, window: int | None = None) -> int:
    """Unmasked (query, key) pairs of one head: the work this input needs
    (``chip_smoke._attn_pairs``, in closed form where there is no window)."""
    if window is None:
        if not causal:
            return Sq * Skv
        full = min(Sq, Skv)  # rows i < Skv see i + 1 keys, later rows all Skv
        return full * (full + 1) // 2 + max(0, Sq - Skv) * Skv
    n = 0
    for i in range(Sq):
        hi = min(i, Skv - 1) if causal else Skv - 1
        lo = max(0, i - window + 1)
        n += max(0, hi - lo + 1)
    return n


def flash_bounds(BH: int, g: int, Sq: int, Skv: int, hd: int, causal: bool = True,
                 window: int | None = None, hdv: int | None = None) -> dict:
    """The card's least time (ms) for one flash forward call, by bytes and by
    operations: q in, o out, k and v in bf16; QK^T at hd and PV at hd_v."""
    hdv = hdv or hd
    nbytes = (BH * Sq * (hd + hdv) + (BH // g) * Skv * (hd + hdv)) * 2
    flops = 2 * (hd + hdv) * BH * attn_pairs(Sq, Skv, causal, window)
    return {"bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_ops_ms": flops / PEAK_BF16_TC_FLOPS * 1e3}


def scan_fused_fwd_bounds(B: int, S: int, di: int, N: int, esz: int = 2,
                          with_h0: bool = False) -> dict:
    """The fused selective scan's forward: dt, x, B, C read once (and A,
    h0), y and h_last written once in float32; 7 operations per state
    element and step plus one per channel and step, on the float32 units."""
    nbytes = (esz * (2 * B * S * di + 2 * B * S * N) + 4 * di * N
              + 4 * (B * S * di + (2 if with_h0 else 1) * B * di * N))
    flops = 7 * B * S * di * N + B * S * di
    return {"bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_ops_ms": flops / PEAK_FP32_FLOPS * 1e3}


def scan_fused_bwd_bounds(B: int, S: int, di: int, N: int, esz: int = 2,
                          with_h0: bool = False) -> dict:
    """The fused selective scan's backward: dt, x, B, C, A, gy (h0, gh_fin)
    read once, gdt, gx, gB, gC, gA (gh0) written once; 20 operations per
    state element and step on the float32 units."""
    nbytes = (2 * esz * (2 * B * S * di + 2 * B * S * N) + 4 * B * S * di
              + 8 * di * N + 4 * (3 if with_h0 else 1) * B * di * N)
    flops = 20 * B * S * di * N
    return {"bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_ops_ms": flops / PEAK_FP32_FLOPS * 1e3}


def bound_ms(bounds: dict) -> float:
    return max(bounds["bound_bytes_ms"], bounds["bound_ops_ms"])


#: Mamba's leaves that no product reads: the decay's log (an exponent), the
#: skip and the biases (elementwise)
MAMBA_ELEMENTWISE = ("a_log", "d_skip", "conv_b", "dt_b")


def product_params(leaf_shapes: dict, tie_embeddings: bool = False) -> int:
    """Weights that enter a product, from ``{path: shape}``: every leaf but
    the norms' weights, Mamba's ``MAMBA_ELEMENTWISE`` leaves and the
    embedding table where it is a lookup (an untied one)."""
    n = 0
    for path, shape in leaf_shapes.items():
        name = path.rsplit("/", 1)[-1]
        if ("norm" in name or (name == "embedding" and not tie_embeddings)
                or name in MAMBA_ELEMENTWISE):
            continue
        size = 1
        for s in shape:
            size *= s
        n += size
    return n


def train_model_flops(leaf_shapes: dict, batch: int, seq: int, *, attn_layers: int = 0,
                      heads: int = 0, hd_qk: int = 0, hd_v: int = 0,
                      window: int | None = None, tie_embeddings: bool = False) -> float:
    """Model FLOPs of one train step (``chip_smoke._model_flops``): 6 per
    token and weight of every product, and the attention layers' QK^T and PV
    over the unmasked pairs, forward and backward (3x); rematerialised work
    is not counted.  The selective scan is elementwise and counts none."""
    out = 6 * product_params(leaf_shapes, tie_embeddings) * batch * seq
    if attn_layers:
        pairs = attn_pairs(seq, seq, True, window)
        out += 6 * pairs * (hd_qk + hd_v) * heads * attn_layers * batch
    return float(out)


def prefill_model_flops(leaf_shapes: dict, batch: int, seq: int, *, attn_layers: int = 0,
                        heads: int = 0, hd_qk: int = 0, hd_v: int = 0,
                        window: int | None = None, vocab_d: int = 0) -> float:
    """Model FLOPs of one prefill over a padded batch: 2 per token and weight
    of every product but the head, which runs on the last position only
    (``vocab_d`` = its weights), and the attention's causal pairs forward."""
    body = product_params(leaf_shapes) - vocab_d
    out = 2 * body * batch * seq + 2 * vocab_d * batch
    if attn_layers:
        out += 2 * attn_pairs(seq, seq, True, window) * (hd_qk + hd_v) * heads \
            * attn_layers * batch
    return float(out)


def decode_step_bound_s(*, weight_bytes: float, batch: int, d_model: int, product_weights: int,
                        attn_layers: int = 0, kv_heads: int = 0, heads: int = 0,
                        head_dim: int = 0, pos: int = 0,
                        mamba_layers: int = 0, d_inner: int = 0, d_state: int = 0,
                        d_conv: int = 0) -> dict:
    """The least time of one decode step of ``batch`` tokens at cache
    position ``pos``: weights read once, the embedding rows read, the KV
    cache read up to ``pos`` and the new entries written; a Mamba layer's
    float32 state read and written and its bf16 conv window.  FLOPs: 2 per
    token and product weight, the attention's scores and values over
    ``pos + 1`` keys, the recurrence's update and readout (4 per state
    element).  Returns seconds by bytes and by operations."""
    nbytes = weight_bytes + batch * d_model * 2
    flops = 2 * product_weights * batch
    if attn_layers:
        per_layer = batch * kv_heads * head_dim * 2 * 2  # one bf16 k and one v entry
        nbytes += attn_layers * per_layer * (pos + 2)  # read pos + 1 entries, write one
        flops += attn_layers * 2 * 2 * batch * heads * head_dim * (pos + 1)
    if mamba_layers:
        nbytes += mamba_layers * batch * d_inner * (2 * 4 * d_state + 2 * 2 * (d_conv - 1))
        flops += mamba_layers * 4 * batch * d_inner * d_state
    return {"bytes_s": nbytes / PEAK_BYTES_PER_S, "ops_s": flops / PEAK_BF16_TC_FLOPS}
