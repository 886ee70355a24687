"""Support-region geometry: masked footholds → halfspace constraints (≙
``quadruped_locomotion_tpu/terrain/support_polygon.py``).

Fixed-shape and mask-driven over leading batch dims:

* 3-4 support legs → the convex polygon through the supported feet in
  counter-clockwise leg order (LF, LH, RH, RF), shrunk inward by
  ``margin``;
* 2 support legs → the connecting segment thickened into a thin
  rectangle;
* ≤1 support leg → a small box around the single foot (or the origin).

Constraints are (normals (...,MAX_EDGES,2), offsets (...,MAX_EDGES)) with
padded rows satisfied everywhere: x is inside iff ``normals @ x >=
offsets`` row-wise.
"""

from __future__ import annotations

import torch

MAX_EDGES = 6
# Counter-clockwise traversal of the legs seen from above
# (+x forward, +y left): LF → LH → RH → RF.
CCW_ORDER = (0, 3, 2, 1)
LINE_THICKNESS = 0.001
DEFAULT_MARGIN = 0.04


def _rows(a, idx):
    """a (...,4,2) gathered along the leg axis at idx (...,4)."""
    return torch.gather(a, -2, idx[..., None].expand(idx.shape + (2,)))


def _pad(normals, offsets):
    """Two always-true rows (0, 0) >= -1 after the four of a case."""
    zn = torch.zeros_like(normals[..., :2, :])
    zo = torch.full_like(offsets[..., :2], -1.0)
    return torch.cat([normals, zn], -2), torch.cat([offsets, zo], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def support_halfspaces(
    feet_xy: torch.Tensor,  # (...,4,2) foot positions
    support: torch.Tensor,  # (...,4) bool
    margin: float | torch.Tensor = DEFAULT_MARGIN,  # number or (...)
):
    """Inward halfspaces of the support region: (normals, offsets);
    ``normals @ x >= offsets`` (all rows) ⇔ x inside the shrunk region."""
    dev = feet_xy.device
    m = torch.as_tensor(margin, dtype=feet_xy.dtype, device=dev)
    order = torch.tensor(CCW_ORDER, device=dev)
    sup = support[..., order]
    pts = feet_xy[..., order, :]
    n_sup = sup.to(torch.int32).sum(-1)

    # Compact the supported points to the front, keeping the ccw order.
    idx = torch.arange(4, device=dev)
    key = torch.where(sup, 0, 1) * 8 + idx
    perm = torch.argsort(key, dim=-1, stable=True)
    cpts = _rows(pts, perm)  # the first n_sup rows: the ccw support feet
    nxt = torch.where(idx + 1 >= n_sup[..., None], 0, idx + 1)

    # --- polygon case (n_sup >= 3): edge i = cpts[i] -> cpts[nxt[i]]
    e = _rows(cpts, nxt) - cpts
    nrm = torch.stack([-e[..., 1], e[..., 0]], dim=-1)  # inward (ccw)
    nlen = torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True), min=1e-9)
    nrm = nrm / nlen
    m_ = m[..., None]
    off = _dot(nrm, cpts) + m_
    edge_valid = idx < n_sup[..., None]
    poly = _pad(torch.where(edge_valid[..., None], nrm, torch.zeros_like(nrm)),
                torch.where(edge_valid, off, torch.full_like(off, -1.0)))

    # --- 2-leg case: the segment thickened into a rectangle; the margin
    # shrinks its length, not its thickness
    p0, p1 = cpts[..., 0, :], cpts[..., 1, :]
    d = p1 - p0
    dlen = torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    t = d / dlen
    q = torch.stack([-t[..., 1], t[..., 0]], dim=-1)
    h = LINE_THICKNESS
    line_n = torch.stack([q, -q, t, -t], dim=-2)
    line_o = torch.stack([_dot(q, p0) - h, -_dot(q, p0) - h, _dot(t, p0) + m,
                          -_dot(t, p1) + m], dim=-1)
    line = _pad(line_n, line_o)

    # --- ≤1-leg case: a small box around the foot (or the origin)
    c = torch.where((n_sup >= 1)[..., None], cpts[..., 0, :],
                    torch.zeros_like(cpts[..., 0, :]))
    box = 0.02
    box_n = feet_xy.new_tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0],
                                [0.0, -1.0]]).expand(c.shape[:-1] + (4, 2))
    box_o = torch.stack([c[..., 0] - box, -c[..., 0] - box, c[..., 1] - box,
                         -c[..., 1] - box], dim=-1)
    boxes = _pad(box_n, box_o)

    many, two = (n_sup >= 3)[..., None], (n_sup == 2)[..., None]
    normals = torch.where(many[..., None], poly[0],
                          torch.where(two[..., None], line[0], boxes[0]))
    offsets = torch.where(many, poly[1], torch.where(two, line[1], boxes[1]))
    return normals, offsets


def point_inside(normals, offsets, x, tol: float = 0.0):
    """True (...) if x (...,2) satisfies every halfspace (with tolerance)."""
    return ((normals @ x[..., None])[..., 0] >= offsets - tol).all(-1)


def violation(normals, offsets, x):
    """Max constraint violation at x (≤ 0 ⇒ inside)."""
    return (offsets - (normals @ x[..., None])[..., 0]).amax(-1)
