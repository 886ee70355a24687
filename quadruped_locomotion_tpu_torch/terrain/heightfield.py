"""Terrain as tensors: heightfield, traversability and the foothold search
(≙ ``quadruped_locomotion_tpu/terrain/heightfield.py``).

Every field carries a leading scenario axis B: one map per scenario, all
of one (H, W) shape. Queries take points ``xy`` of shape (B, ..., 2) and
read scenario b's map for the points of row b (advanced indexing
``height[b, iy, ix]``). The foothold search is a fixed K×K window around
each nominal foothold, scored by distance (the reference's nearest-first
spiral); ties go to the first cell in row-major window order, as
``jnp.argmin`` and ``torch.argmin`` both choose.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..types import TensorStruct, resolve_device

TRAVERSABILITY_THRESHOLD = 0.9
SEARCH_WINDOW = 9  # cells per side (odd)


@dataclass
class Heightfield(TensorStruct):
    """Dense terrain maps, row-major: ``height[b, iy, ix]``."""

    origin: torch.Tensor  # (B,2) world xy of cell (0, 0)'s centre
    resolution: torch.Tensor  # (B,) metres per cell
    height: torch.Tensor  # (B,H,W)
    traversability: torch.Tensor  # (B,H,W) in [0, 1]
    normals: torch.Tensor  # (B,H,W,3) unit surface normals

    @classmethod
    def flat(cls, batch: int, extent: float = 4.0, resolution: float = 0.04,
             height: float = 0.0, device=None,
             dtype=torch.float32) -> "Heightfield":
        dev = resolve_device(device)
        n = int(round(2 * extent / resolution))
        h = torch.full((batch, n, n), height, dtype=dtype, device=dev)
        nrm = torch.zeros((batch, n, n, 3), dtype=dtype, device=dev)
        nrm[..., 2] = 1.0
        return cls(
            origin=torch.full((batch, 2), -extent, dtype=dtype, device=dev),
            resolution=torch.full((batch,), resolution, dtype=dtype,
                                  device=dev),
            height=h, traversability=torch.ones_like(h), normals=nrm)

    @classmethod
    def from_height_array(cls, height: torch.Tensor, origin=(-2.0, -2.0),
                          resolution=0.04,
                          traversability: torch.Tensor | None = None
                          ) -> "Heightfield":
        """Maps from heights (B,H,W) on their device; ``origin`` (2,) or
        (B,2), ``resolution`` a float or (B,). Normals and (by default)
        traversability are derived from the heights."""
        h = height
        B = h.shape[0]
        f = lambda x: torch.as_tensor(x, dtype=h.dtype, device=h.device)  # noqa: E731
        res = f(resolution).expand(B)
        if traversability is None:
            traversability = _traversability_from_slope(h, res)
        return cls(
            origin=f(origin).expand(B, 2).clone(),
            resolution=res.clone(),
            height=h,
            traversability=traversability.to(h.dtype),
            normals=_normals_from_height(h, res),
        )

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.height.shape[-2:])

    def _rel(self, xy: torch.Tensor) -> torch.Tensor:
        origin = _lift(self.origin, xy.dim())
        res = _lift(self.resolution, xy.dim())[..., None]
        return (xy - origin) / res

    def gather(self, field: torch.Tensor, ix: torch.Tensor,
               iy: torch.Tensor) -> torch.Tensor:
        """``field[b, iy, ix]`` for index tensors of shape (B, ...)."""
        b = torch.arange(field.shape[0], device=field.device)
        return field[b.reshape((-1,) + (1,) * (ix.dim() - 1)), iy, ix]

    def cell_index(self, xy: torch.Tensor):
        """(ix, iy) of the cells containing world xy (B, ..., 2), clamped
        to the map; rel rounds half to even."""
        rel = self._rel(xy)
        H, W = self.shape
        ix = torch.clamp(torch.round(rel[..., 0]).long(), 0, W - 1)
        iy = torch.clamp(torch.round(rel[..., 1]).long(), 0, H - 1)
        return ix, iy

    def height_at(self, xy: torch.Tensor) -> torch.Tensor:
        """Bilinear height at world xy (B, ..., 2) -> (B, ...), clamped to
        ``shape - 1.001`` cells before the floor."""
        rel = self._rel(xy)
        H, W = self.shape
        x = torch.clamp(rel[..., 0], 0.0, W - 1.001)
        y = torch.clamp(rel[..., 1], 0.0, H - 1.001)
        x0f, y0f = torch.floor(x), torch.floor(y)
        x0, y0 = x0f.long(), y0f.long()
        fx, fy = x - x0f, y - y0f
        h = self.height
        h00 = self.gather(h, x0, y0)
        h01 = self.gather(h, x0 + 1, y0)
        h10 = self.gather(h, x0, y0 + 1)
        h11 = self.gather(h, x0 + 1, y0 + 1)
        return (h00 * (1 - fx) * (1 - fy) + h01 * fx * (1 - fy)
                + h10 * (1 - fx) * fy + h11 * fx * fy)

    def normal_at(self, xy: torch.Tensor) -> torch.Tensor:
        return self.gather(self.normals, *self.cell_index(xy))

    def traversability_at(self, xy: torch.Tensor) -> torch.Tensor:
        return self.gather(self.traversability, *self.cell_index(xy))


def _lift(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-scenario (B, *tail) -> (B, 1, ..., 1, *tail) against a tensor
    of ``ndim`` dims whose last holds xy."""
    return a.reshape(a.shape[:1] + (1,) * (ndim - 2) + a.shape[1:])


def _normals_from_height(h: torch.Tensor,
                         resolution: torch.Tensor) -> torch.Tensor:
    """Central differences with wrap-around at the borders (the reference
    uses ``jnp.roll``): (B,H,W), resolution (B,) -> (B,H,W,3)."""
    two_res = (2 * resolution)[:, None, None]
    dzdx = (torch.roll(h, -1, -1) - torch.roll(h, 1, -1)) / two_res
    dzdy = (torch.roll(h, -1, -2) - torch.roll(h, 1, -2)) / two_res
    n = torch.stack([-dzdx, -dzdy, torch.ones_like(h)], dim=-1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def _traversability_from_slope(h: torch.Tensor, resolution: torch.Tensor,
                               critical_slope: float = 0.3,
                               falloff: float = 0.25) -> torch.Tensor:
    """Full traversability below ``critical_slope`` (rad), linear falloff
    to zero over ``falloff`` rad beyond it, times a step filter: cells
    far from the mean of their 5×5 neighbourhood (edge-padded) are not
    steppable. (B,H,W) -> (B,H,W)."""
    n = _normals_from_height(h, resolution)
    slope = torch.arccos(torch.clamp(n[..., 2], -1.0, 1.0))
    t_slope = torch.clamp(
        1.0 - torch.clamp(slope - critical_slope, min=0.0) / falloff, 0.0, 1.0)
    k = 5
    kernel = torch.ones((1, 1, k, k), dtype=h.dtype, device=h.device) / (k * k)
    padded = F.pad(h[:, None], (k // 2,) * 4, mode="replicate")
    mean = F.conv2d(padded, kernel)[:, 0]
    step = torch.abs(h - mean)
    t_step = torch.clamp(
        1.0 - torch.clamp(step - 0.02, min=0.0) / 0.03, 0.0, 1.0)
    return t_slope * t_step


def optimize_footholds(
    hf: Heightfield,
    nominal: torch.Tensor,  # (B,...,3) nominal footholds (world)
    hips_world: torch.Tensor | None = None,  # (B,...,3) kinematic hips
    max_reach: float = 0.55,
    window: int = SEARCH_WINDOW,
    threshold: float = TRAVERSABILITY_THRESHOLD,
):
    """Nearest traversable cell to each nominal foothold within a
    ``window``² search (and within ``max_reach`` of the hip, when hips
    are given). Returns (footholds (B,...,3) at the chosen cell's centre
    with the map height, normals (B,...,3) of that cell, found (B,...));
    one call serves one foothold per scenario or all four legs. Where
    no cell qualifies, the nominal xy with the map height and found =
    False."""
    nominal_xy = nominal[..., :2]
    dtype = nominal.dtype
    k = window // 2
    H, W = hf.shape
    ix, iy = hf.cell_index(nominal_xy)  # (B,...)
    offs = torch.arange(-k, k + 1, device=nominal.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    cx = torch.clamp(ix[..., None, None] + ox, 0, W - 1)  # (B,...,K,K)
    cy = torch.clamp(iy[..., None, None] + oy, 0, H - 1)

    origin = _lift(hf.origin, nominal.dim() + 2)  # (B,1,...,1,2)
    res = _lift(hf.resolution, nominal.dim() + 2)[..., None]
    cell_xy = origin + torch.stack([cx, cy], dim=-1).to(dtype) * res
    trav = hf.gather(hf.traversability, cx, cy)
    d2 = ((cell_xy - nominal_xy[..., None, None, :]) ** 2).sum(-1)

    ok = trav >= threshold
    if hips_world is not None:
        cell_z = hf.gather(hf.height, cx, cy)
        cell_xyz = torch.cat([cell_xy, cell_z[..., None]], dim=-1)
        reach2 = ((cell_xyz - hips_world[..., None, None, :]) ** 2).sum(-1)
        ok = ok & (reach2 <= max_reach ** 2)

    score = torch.where(ok, d2, torch.full_like(d2, float("inf"))).flatten(-2)
    best = torch.argmin(score, dim=-1)  # first minimum in window order
    found = torch.isfinite(torch.gather(score, -1, best[..., None])[..., 0])
    cand = cell_xy.flatten(-3, -2)  # (B,...,K*K,2)
    picked = torch.gather(
        cand, -2, best[..., None, None].expand(best.shape + (1, 2)))[..., 0, :]
    best_xy = torch.where(found[..., None], picked, nominal_xy)
    z = hf.height_at(best_xy)
    normal = hf.normal_at(best_xy)
    return torch.cat([best_xy, z[..., None]], dim=-1), normal, found


def optimize_foothold(
    hf: Heightfield,
    nominal_xy: torch.Tensor,  # (B, 2) desired foothold, one per map
    hip_world: torch.Tensor | None = None,  # (B, 3) kinematic hip
    max_reach: float = 0.55,
    window: int = SEARCH_WINDOW,
    threshold: float = TRAVERSABILITY_THRESHOLD,
):
    """The single-foot form of :func:`optimize_footholds` (≙
    ``FootstepOptimization::getOptimizedFoothold``): one nominal foothold
    xy per map. Returns (foothold (B, 3), normal (B, 3), found (B,))."""
    nominal = torch.cat([nominal_xy, torch.zeros_like(nominal_xy[..., :1])],
                        dim=-1)
    return optimize_footholds(hf, nominal, hip_world, max_reach, window,
                              threshold)
