"""The plain PyTorch versions of K7 (counterpart of
``repro.kernels.ssd_chunk.ref``): the exact SSD recurrence, the tests'
oracle, and the chunked math that the CUDA kernel computes, for any
number of B/C groups, and a mirror of the CUDA kernel's four passes.
The wrapper runs the chunked version on CPU tensors; on the card its
backward recomputes it for the vector-Jacobian product (K7 has no
backward kernel), and ``chip_smoke.py`` and the CUDA tests hold the
kernel to it.
The four-pass mirror is for the tests alone."""

from __future__ import annotations

import torch


def ssd_sequential_ref(x, dt, A, Bm, Cm, init_state):
    """Exact recurrence, one step a token.

    x (B, T, H, P), dt (B, T, H), A (H,), Bm / Cm (B, T, N),
    init_state (B, H, P, N).  Returns (y (B, T, H, P) in x's dtype,
    final_state (B, H, P, N) f32)."""
    S = init_state.float()
    A = A.float()
    ys = []
    for t in range(x.shape[1]):
        x_t, dt_t = x[:, t].float(), dt[:, t].float()          # (B,H,P) (B,H)
        b_t, c_t = Bm[:, t].float(), Cm[:, t].float()          # (B,N)
        decay = torch.exp(dt_t * A)                             # (B,H)
        S = decay[:, :, None, None] * S + (
            (dt_t[:, :, None] * x_t)[:, :, :, None] * b_t[:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", S, c_t))
    return torch.stack(ys, dim=1).to(x.dtype), S


def ssd_chunked_ref(x, dt, A, Bm, Cm, init_state, *, chunk: int = 128):
    """Chunked SSD: the Pallas kernel's math, any G.

    Bm / Cm are (B, T, N) for G = 1 or (B, T, G, N); head h reads group
    ``h // (H / G)``.  T must be a multiple of ``chunk``.  A loop over the
    chunks carries the (B, H, P, N) state, as the reference's ``lax.scan``
    does."""
    B, T, H, P = x.shape
    if Bm.dim() == 3:
        Bm, Cm = Bm[:, :, None, :], Cm[:, :, None, :]
    G, N = Bm.shape[2], Bm.shape[3]
    if T % chunk:
        raise ValueError(f"ssd_chunked_ref: T {T} is not a multiple of "
                         f"chunk {chunk}")
    nc = T // chunk
    xf = x.float().reshape(B, nc, chunk, H, P)
    dtf = dt.float().reshape(B, nc, chunk, H)
    bf = Bm.float().reshape(B, nc, chunk, G, N)
    cf = Cm.float().reshape(B, nc, chunk, G, N)
    A = A.float()
    group_of_head = torch.arange(H, device=x.device) // (H // G)
    ar = torch.arange(chunk, device=x.device)
    causal = (ar[:, None] >= ar[None, :])[None, :, :, None]     # (1,Q,Q,1)
    S = init_state.float()
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc = xf[:, c], dtf[:, c], bf[:, c], cf[:, c]
        # each prefix summed in f64 and rounded once to f32, on every
        # device (the decays below are exponentials of differences of
        # prefixes that reach |cum| ~ 2,000 at the model's ranges)
        cum = torch.cumsum(dtc * A, dim=1, dtype=torch.float64).float()
        total = cum[:, -1]                                      # (B,H)
        CB = torch.einsum("bign,bjgn->bijg", cc, bc)            # (B,Q,Q,G)
        CBh = CB[..., group_of_head]                            # (B,Q,Q,H)
        # clamp before exp: the i < j entries are masked below, but
        # unclamped they overflow to inf (the reference's NaN-grad note)
        L = torch.exp(torch.clamp(cum[:, :, None, :] - cum[:, None, :, :],
                                  max=0.0))
        W = torch.where(causal, CBh * L * dtc[:, None, :, :], 0.0)
        y_intra = torch.einsum("bijh,bjhp->bihp", W, xc)
        ch = cc[:, :, group_of_head, :]                         # (B,Q,H,N)
        y_state = torch.exp(cum)[..., None] * torch.einsum(
            "bihn,bhpn->bihp", ch, S)
        w = torch.exp(total[:, None, :] - cum) * dtc            # (B,Q,H)
        bh = bc[:, :, group_of_head, :]
        s_add = torch.einsum("bjhp,bjhn->bhpn", xc * w[..., None], bh)
        S = torch.exp(total)[:, :, None, None] * S + s_add
        ys.append(y_intra + y_state)
    return torch.stack(ys, dim=1).reshape(B, T, H, P).to(x.dtype), S


def ssd_chunk_passes_ref(x, dt, A, Bm, Cm, init_state, *, chunk: int = 128):
    """The CUDA kernel's four passes in plain torch, with its scratch
    layout, vectorised over the chunks (only pass 3 loops).

    Same arguments as :func:`ssd_chunked_ref`.  Returns (y, final_state,
    scratch), scratch holding
      ``CB``  (B, T/Q, G, Q, Q): pass 1's causal C.B^T of each chunk and
              group, j-major: ``CB[..., j, i] = C_i . B_j`` for j <= i,
              else 0 (the kernel pads each to Q rounded up to 16);
      ``cum`` (B, T, H): pass 1's inclusive prefix of dt * A within each
              chunk, summed in f64 and rounded once to f32;
      ``S``   (B, T/Q, H, N, P): after pass 3, the state entering each
              chunk (pass 2 leaves each chunk's own contribution there).
    """
    B, T, H, P = x.shape
    if Bm.dim() == 3:
        Bm, Cm = Bm[:, :, None, :], Cm[:, :, None, :]
    G, N = Bm.shape[2], Bm.shape[3]
    if T % chunk:
        raise ValueError(f"ssd_chunk_passes_ref: T {T} is not a multiple of "
                         f"chunk {chunk}")
    nc, Q = T // chunk, chunk
    xf = x.float().reshape(B, nc, Q, H, P)
    dtf = dt.float().reshape(B, nc, Q, H)
    bf = Bm.float().reshape(B, nc, Q, G, N)
    cf = Cm.float().reshape(B, nc, Q, G, N)
    gh = torch.arange(H, device=x.device) // (H // G)
    ar = torch.arange(Q, device=x.device)
    causal_ji = ar[:, None] <= ar[None, :]                      # [j, i]

    # pass 1, one block per (b, c, g): C.B^T once, and cum per head
    CB = torch.where(causal_ji, torch.einsum("bcjgn,bcign->bcgji", bf, cf),
                     0.0)
    cum = torch.cumsum(dtf * A.float(), dim=2, dtype=torch.float64).float()
    total = cum[:, :, -1]                                       # (B,nc,H)

    # pass 2, one block per (b, c, h): each chunk's own state contribution
    w = torch.exp(total[:, :, None] - cum) * dtf                # (B,nc,Q,H)
    S = torch.einsum("bcjhp,bcjhn->bchnp", xf * w[..., None],
                     bf[:, :, :, gh])

    # pass 3, sequential over the chunks: S[c] becomes the state entering
    # chunk c
    s = init_state.float().transpose(-1, -2)                    # (B,H,N,P)
    dec = torch.exp(total)[..., None, None]
    for c in range(nc):
        add = S[:, c].clone()
        S[:, c] = s
        s = dec[:, c] * s + add

    # pass 4, one block per (b, c, h): the outputs
    CBh = CB[:, :, gh].permute(0, 1, 4, 3, 2)                   # (B,nc,Qi,Qj,H)
    L = torch.exp(torch.clamp(cum[:, :, :, None] - cum[:, :, None],
                              max=0.0))
    W = torch.where(causal_ji.T[None, None, :, :, None],
                    CBh * L * dtf[:, :, None], 0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xf)
    y_state = torch.exp(cum)[..., None] * torch.einsum(
        "bcihn,bchnp->bcihp", cf[:, :, :, gh], S)
    y = (y_intra + y_state).reshape(B, T, H, P).to(x.dtype)
    return y, s.transpose(-1, -2), {"CB": CB, "cum": cum.reshape(B, T, H),
                                    "S": S}
