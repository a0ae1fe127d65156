"""The fused reconstruction contraction, K1 (port of
`mplc_tpu/ops/recon_kernel.py`).

Any coalition's model is rebuilt from one recorded grand-coalition run by
replaying the recorded rounds restricted to the coalition. The renormalized
weight of partner p in round r depends only on the mask and the recorded
weights,

    WN[b, r, p] = w[r, p] m[b, p] / sum_q w[r, q] m[b, q]   (0 when the
                  denominator is 0: the zero-weight pass-through)

so the whole replay is one contraction over the flattened recorded stream:

    out[b, :] = init[:] + WN[b] (flattened to K = R*P) @ deltas [K, D]

`fused_contract` computes it: on CUDA tensors with the hand-written kernel
`csrc/recon_matmul.cu` (which replaces the Pallas TPU kernel
`mplc_tpu/ops/recon_kernel.py::_recon_matmul_kernel`), on CPU tensors with
its plain PyTorch version `fused_contract_reference`. The choice follows the
tensors' device and nothing else; on any device other than the CPU the
wrapper launches the kernel or raises, it never falls back.

`fused_contract_bf16` is the same function on bf16 WN and bf16 deltas with
fp32 `init`, fp32 accumulation and an fp32 result: the Pallas kernel's
instantiation under `precision="bf16"`, on the card the kernel
`csrc/recon_matmul_bf16.cu`. Every bf16 x bf16 product is exact in fp32,
so its plain version upcasts both operands and does one fp32 product.

Numerics: each kernel sums in fp32 in another association than its plain
version, so the two agree to rtol 1e-4 / atol 1e-5, not bit for bit. K1
forms its products on the tensor cores from TF32 pieces (3xTF32) and sums
them with compensation, which keeps it nearer the exact sum than the plain
fp32 product; K1-bf16 sums each 32-row step's exact products from zero and
adds the step's sum to its fp32 accumulator, which keeps it nearer too.
The flattened stream's rows are zero-padded to a multiple of 8 values
(`flatten_stream`), so K1-bf16 copies them in 16-byte pieces. A
coalition whose every round has zero surviving weight reproduces `init`
bit-exactly on both (its WN rows are exact zeros, in bf16 too).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

KERNEL = "recon_matmul"
KERNEL_BF16 = "recon_matmul_bf16"
KERNELS = (KERNEL, KERNEL_BF16)

# Launches of each CUDA kernel in this process (plain counts; a run resets
# them to 0 to see which kernels its main path went through), and each
# kernel's launches by batch width B (reset with them, to {}).
launches = 0
launches_bf16 = 0
launch_widths: dict[int, int] = {}
launch_widths_bf16: dict[int, int] = {}

# Every row of the flattened stream is padded with zeros to a multiple of
# this many values, so that a bf16 row is a whole number of 16-byte units
# (K1-bf16 copies d in 16-byte pieces) and an fp32 row of 32 bytes
ROW_ALIGN = 8


def normalized_round_weights(masks: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """WN [B, R, P]: each round's masked weights renormalized to sum to 1;
    rounds with a zero denominator (early-stopped tail, no surviving
    member) give exact-zero rows."""
    ws = weights[None, :, :] * masks[:, None, :]
    denom = torch.sum(ws, dim=-1, keepdim=True)
    return torch.where(denom > 0, ws / torch.clamp(denom, min=1e-12),
                       torch.zeros((), dtype=ws.dtype, device=ws.device))


def fused_contract_reference(wn2: torch.Tensor, d2: torch.Tensor,
                             init: torch.Tensor) -> torch.Tensor:
    """The plain version: init[None, :] + wn2 @ d2, in fp32."""
    return init.reshape(1, -1) + wn2 @ d2


def fused_contract_bf16_reference(wn2: torch.Tensor, d2: torch.Tensor,
                                  init: torch.Tensor) -> torch.Tensor:
    """The plain version of the bf16 variant: both operands upcast (exact),
    one fp32 product, plus init; fp32 [B, D]."""
    return init.reshape(1, -1) + wn2.float() @ d2.float()


@functools.cache
def _kernel_fn(name: str, symbol: str):
    """`symbol` of `name`'s library, bound once per process."""
    fn = getattr(cuda_build.load(name), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_checked(name: str, symbol: str, wn2: torch.Tensor, d2: torch.Tensor,
                    init: torch.Tensor, operand_dtype: torch.dtype) -> torch.Tensor:
    """Launch `name`'s kernel on the current CUDA stream after checking its
    inputs: wn2 [B, K] and d2 [K, D] of `operand_dtype`, init [D] float32,
    all contiguous CUDA tensors on one device. Raises on anything else."""
    tensors = {"wn2": wn2, "d2": d2, "init": init}
    for tname, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"the {name} kernel needs CUDA tensors; "
                             f"{tname} is on {t.device}")
        want = torch.float32 if tname == "init" else operand_dtype
        if t.dtype != want:
            raise ValueError(f"{name}: {tname} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError("wn2, d2 and init must be on one device")
    if wn2.ndim != 2 or d2.ndim != 2:
        raise ValueError("wn2 must be [B, K] and d2 [K, D]")
    B, K = wn2.shape
    D = d2.shape[1]
    if d2.shape[0] != K or init.numel() != D:
        raise ValueError(f"shape mismatch: wn2 {tuple(wn2.shape)}, d2 "
                         f"{tuple(d2.shape)}, init {tuple(init.shape)}")
    if B >= 2 ** 31 or K >= 2 ** 31:
        raise ValueError("B and K must fit in a 32-bit int")
    out = torch.empty((B, D), dtype=torch.float32, device=wn2.device)
    if B == 0 or D == 0:
        return out
    with torch.cuda.device(wn2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn(name, symbol)(wn2.data_ptr(), d2.data_ptr(),
                                       init.data_ptr(), out.data_ptr(), B, K,
                                       D, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def _launch(wn2: torch.Tensor, d2: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """Launch K1 (fp32 operands); raises on any input it does not take."""
    global launches
    out = _launch_checked(KERNEL, "recon_matmul_f32", wn2, d2, init, torch.float32)
    launches += 1
    B = wn2.shape[0]
    launch_widths[B] = launch_widths.get(B, 0) + 1
    return out


def _launch_bf16(wn2: torch.Tensor, d2: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """Launch K1-bf16 (bf16 operands, fp32 init and result); raises on any
    input it does not take."""
    global launches_bf16
    out = _launch_checked(KERNEL_BF16, "recon_matmul_bf16", wn2, d2, init,
                          torch.bfloat16)
    launches_bf16 += 1
    B = wn2.shape[0]
    launch_widths_bf16[B] = launch_widths_bf16.get(B, 0) + 1
    return out


def fused_contract(wn2: torch.Tensor, d2: torch.Tensor,
                   init: torch.Tensor) -> torch.Tensor:
    """out[B, D] = init[None, :] + wn2 @ d2 (fp32): the CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU."""
    if wn2.device.type == "cpu":
        return fused_contract_reference(wn2, d2, init)
    return _launch(wn2, d2, init)


def fused_contract_bf16(wn2: torch.Tensor, d2: torch.Tensor,
                        init: torch.Tensor) -> torch.Tensor:
    """out[B, D] = init[None, :] + wn2 @ d2 from bf16 wn2 and d2 and fp32
    init, summed in fp32 to an fp32 result: the CUDA kernel for tensors on
    the card, the plain version for tensors on the CPU."""
    if wn2.device.type == "cpu":
        return fused_contract_bf16_reference(wn2, d2, init)
    return _launch_bf16(wn2, d2, init)


# ---------------------------------------------------------------------------
# flattening the recorded stream to the kernel's [K, D] layout and back
# ---------------------------------------------------------------------------

def stream_dtype(precision: str) -> torch.dtype:
    """The dtype reconstruction reads the recorded deltas in."""
    return torch.bfloat16 if precision == "bf16" else torch.float32


def flatten_stream(init_params: dict, deltas: dict, K: int,
                   dtype: torch.dtype = torch.float32, device=None):
    """(init [Dp] float32, d2 [K, Dp] in `dtype`, layout) from a parameter
    dict and its recorded deltas ([R, P, ...] leaves, K = R*P), on `device`
    (default: the deltas'): every leaf flattened and laid side by side, so
    the whole stream is one contraction, then zero columns up to Dp = D
    rounded up to ROW_ALIGN (they reconstruct to exact zeros, which
    `unflatten` never reads). `layout` lists (group, name, shape) in that
    order, for `unflatten`. Built round by round (`flatten_rounds`)."""
    leaf = next(t for d in deltas.values() for t in d.values())
    R, P = leaf.shape[:2]
    if R * P != K:
        raise ValueError(f"K = {K} is not the deltas' rounds x partners ({R} x {P})")
    rounds = [{g: {k: t[r] for k, t in d.items()} for g, d in deltas.items()}
              for r in range(R)]
    return flatten_rounds(init_params, rounds, P, dtype,
                          leaf.device if device is None else device)


def flatten_rounds(init_params: dict, rounds: list, P: int,
                   dtype: torch.dtype, device) -> tuple:
    """`flatten_stream`'s (init, d2, layout) on `device` from a list of
    rounds, each a dict of [P, ...] leaves (tensors or host arrays; a live
    game's resident history), K = len(rounds)*P. d2 is allocated there once
    and each round's leaves are moved there and copied (cast there) into
    their rows and columns: a host stream is never stacked, joined or cast
    on the host, and the device holds d2 and one leaf beside it."""
    layout = [(g, k, tuple(t.shape)) for g, d in init_params.items()
              for k, t in d.items()]
    init = torch.cat([torch.as_tensor(init_params[g][k]).reshape(-1).float()
                      for g, k, _ in layout])
    D = init.numel()
    pad = -D % ROW_ALIGN
    init = torch.cat([init, init.new_zeros(pad)]).to(device)
    d2 = torch.empty((len(rounds) * P, D + pad), dtype=dtype, device=device)
    d2[:, D:].zero_()
    for r, deltas in enumerate(rounds):
        off = 0
        for g, k, _ in layout:
            leaf = torch.as_tensor(deltas[g][k]).reshape(P, -1)
            d2[r * P:(r + 1) * P, off:off + leaf.shape[1]].copy_(leaf.to(device))
            off += leaf.shape[1]
    return init, d2, layout


def unflatten(out: torch.Tensor, layout) -> dict:
    """Per-leaf [B, *shape] views of a flat [B, Dp] batch of parameters
    (each leaf sliced at its offset; the padded tail is never read)."""
    B, off, params = out.shape[0], 0, {}
    for g, k, shape in layout:
        size = 1
        for s in shape:
            size *= s
        params.setdefault(g, {})[k] = out[:, off:off + size].view((B,) + shape)
        off += size
    return params


def reconstruct_flat(masks: torch.Tensor, init: torch.Tensor, d2: torch.Tensor,
                     weights: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """[B, Dp] reconstructed flat parameters of B coalitions (masks [B, P])
    from an already flattened stream (init [Dp] float32, d2 [K, Dp] in
    `stream_dtype(precision)`, weights [R, P]), in one fused contraction.
    float32 under fp32 and mixed; under bf16 the round weights are cast to
    bf16, the contraction sums in fp32 and the result is cast to bf16."""
    B = masks.shape[0]
    wn2 = normalized_round_weights(masks, weights).reshape(B, -1)
    if precision != "bf16":
        return fused_contract(wn2.contiguous(), d2, init)
    wn2 = wn2.to(torch.bfloat16).contiguous()
    return fused_contract_bf16(wn2, d2, init).to(torch.bfloat16)


def reconstruct_batch(masks: torch.Tensor, init_params: dict, deltas: dict,
                      weights: torch.Tensor, precision: str = "fp32") -> dict:
    """Reconstruct a batch of coalition models in one fused pass.

    masks [B, P] float; init_params a parameter dict; deltas the same dict
    with leaves [R, P, ...]; weights [R, P]. Returns the reconstructed
    parameter dict with a leading batch axis [B, ...]: float32 leaves, bf16
    under `precision="bf16"`."""
    R, P = weights.shape
    init, d2, layout = flatten_stream(init_params, deltas, R * P,
                                      stream_dtype(precision))
    return unflatten(reconstruct_flat(masks, init, d2, weights, precision),
                     layout)
