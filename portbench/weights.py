"""Weights made from the run seed, on the device, in one large draw.

The names, shapes and dtypes come from the port's own module built on the
meta device; the values are one `randn` over all leaves at once, each
leaf's slice scaled by its init (normal with the family's std, or a
constant), then copied out in the leaf's dtype. The reference receives
the same values.
"""

from __future__ import annotations

from portbench.traffic import subseed


def make(meta_net, init_of, seed: int, device, dtype=None) -> dict:
    """{name: tensor} for every parameter of `meta_net` (built on the
    meta device). `init_of(name)` gives ("normal", std) or ("const", v).
    `dtype`: one dtype for every leaf (training's f32 masters), else each
    leaf's own."""
    import torch

    shapes = {n: (t.shape, t.dtype) for n, t in meta_net.state_dict().items()}
    total = sum(s.numel() for s, _ in shapes.values())
    g = torch.Generator(device=device).manual_seed(subseed(seed, 0))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, (shape, dt) in shapes.items():
        n = shape.numel()
        leaf = flat[off:off + n].view(shape)
        off += n
        kind, value = init_of(name)
        if kind == "normal":
            leaf.mul_(value)
        else:
            leaf.fill_(value)
        out[name] = leaf.to(dtype or dt, copy=True)
    return out
