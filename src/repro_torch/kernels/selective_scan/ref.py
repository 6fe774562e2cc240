"""Plain PyTorch version of the selective scan: the naive sequential
Mamba1 recurrence, one time step after the other,

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
    y_t = sum_N h_t * C_t

with the output projection written as the kernel's mul-reduce (not a
matmul), summed over N in the kernel's order (0, 1, ..., N-1, from 0.0):
each operation here is one rounded float32 operation, as in the kernel, so
the two differ at most by ``exp``.  Float32 throughout."""
import torch


def selective_scan_ref(u, dt, A, Bc, Cc, h0):
    """u, dt: (B,S,di); A: (di,N); Bc, Cc: (B,S,N); h0: (B,di,N).  Returns
    (y: (B,S,di), h_last: (B,di,N))."""
    h = h0.float()
    A = A.float()
    ys = []
    for t in range(u.shape[1]):
        u_t, dt_t = u[:, t].float(), dt[:, t].float()
        a = torch.exp(dt_t[:, :, None] * A)
        h = a * h + (dt_t * u_t)[..., None] * Bc[:, t, None, :].float()
        p = h * Cc[:, t, None, :].float()
        y = torch.zeros_like(p[..., 0])
        for n in range(p.shape[-1]):
            y = y + p[..., n]
        ys.append(y)
    return torch.stack(ys, dim=1), h
