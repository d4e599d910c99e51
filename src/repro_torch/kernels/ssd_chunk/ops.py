"""The public SSD wrappers (counterpart of
``repro.kernels.ssd_chunk.ops``): the chunked scan, with its padding,
runs the plain version on CPU tensors and K7 on CUDA tensors (any number
of B/C groups: K7 takes G > 1, where the reference falls back to jnp);
the one-token decode step is plain tensor code, as in the reference.

On the card K7 computes the scan's forward whether or not a gradient is
asked for.  K7 has no backward kernel: the wrapper is an autograd
Function whose backward recomputes the plain chunked scan
(:func:`ssd_chunked_ref`) from the saved inputs under autograd and takes
its vector-Jacobian product, the gradient of the function the reference
trains through (its jnp chunked scan, ``use_pallas=False``), from the
outputs the loss reaches only (a train step's loss does not reach the
final state).  Each such
backward counts itself in ``launches["ssd_chunk_plain_grad"]`` beside
K7's ``launches["ssd_chunk"]``.  A non-reentrant checkpoint's recompute
launches K7 again before that backward."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import on_cpu
from repro_torch.kernels.ssd_chunk import kernel
from repro_torch.kernels.ssd_chunk.ref import ssd_chunked_ref


def ssd_scan(x, dt, A, Bm, Cm, init_state=None, *, chunk: int = 128):
    """Run the SSD scan; returns (y (B, T, H, P), final_state (B, H, P, N)).

    x (B, T, H, P), dt (B, T, H) positive, A (H,) negative, Bm / Cm
    (B, T, N) or (B, T, G, N), init_state (B, H, P, N) or None (zeros).
    T is padded to a chunk multiple with dt = 0 steps, which leave the
    state exactly as it is (decay exp(0) = 1, input weight 0); the padded
    outputs are trimmed."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if init_state is None:
        init_state = torch.zeros((B, H, P, N), dtype=torch.float32,
                                 device=x.device)
    x, dt, Bm, Cm = pad_to_chunks(x, dt, Bm, Cm, chunk)
    if on_cpu(x, dt, A, Bm, Cm, init_state):
        y, fs = ssd_chunked_ref(x, dt, A, Bm, Cm, init_state, chunk=chunk)
    else:
        y, fs = _K7Scan.apply(x, dt, A, Bm, Cm, init_state, chunk)
    return y[:, :T], fs


class _K7Scan(torch.autograd.Function):
    """K7's forward; the backward is the plain chunked scan's VJP."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk):
        # an output the loss does not reach (the final state, in training)
        # comes to backward as None, and its VJP is not taken
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk = chunk
        b4, c4 = (Bm[:, :, None, :], Cm[:, :, None, :]) if Bm.dim() == 3 \
            else (Bm, Cm)
        return kernel.ssd_chunk(
            x.contiguous(), dt.contiguous(), A.contiguous(), b4.contiguous(),
            c4.contiguous(), init_state.contiguous(), chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gfs):
        kernel.launches["ssd_chunk_plain_grad"] += 1
        need = ctx.needs_input_grad[:6]
        ins = [t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            outs = ssd_chunked_ref(*ins, chunk=ctx.chunk)
            used = [(o, g) for o, g in zip(outs, (gy, gfs)) if g is not None]
            wrt = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(
                [o for o, _ in used], wrt, [g for _, g in used],
                allow_unused=True))
        return (*(next(got) if n else None for n in need), None)


def pad_to_chunks(x, dt, Bm, Cm, chunk: int):
    """x, dt, Bm, Cm padded along T (dim 1) with zeros to a multiple of
    ``chunk``; dt = 0 rows leave the scan's state as it is."""
    pad = -x.shape[1] % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        pad_bc = (0, 0) * (Bm.dim() - 2) + (0, pad)
        Bm = F.pad(Bm, pad_bc)
        Cm = F.pad(Cm, pad_bc)
    return x, dt, Bm, Cm


def ssd_decode_step(x_t, dt_t, A, b_t, c_t, state):
    """One token of the recurrence for serving (no kernel: O(H P N)).

    x_t (B, H, P), dt_t (B, H), b_t / c_t (B, N), state (B, H, P, N).
    Returns (y_t (B, H, P), new_state)."""
    decay = torch.exp(dt_t * A[None, :])                        # (B,H)
    state = decay[:, :, None, None] * state + (
        (dt_t[:, :, None] * x_t)[:, :, :, None] * b_t[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", state, c_t)
    return y, state
