"""Panorama pipeline: icosahedral view split and gradient-domain depth merge.

Port of the JAX package's ``moge_tpu/panorama.py`` (reference
moge/utils/panorama.py). The camera rig and every resampling coordinate are
built in numpy, as there; the resampling itself runs in torch on the
device of the image or of the distance maps, matched to ``cv2.remap`` (see
``remap_bilinear`` and ``remap_nearest``), so the card needs no OpenCV and
the views never leave it. The merge assembles the gradient and Laplacian
maps on that device and solves the overdetermined gradient + Poisson system
either by sparse LSMR on the host (scipy, ``solver="lsmr"``) or by a
matrix-free conjugate gradient on the normal equations in torch on the
device (``solver="cg"``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.sparse import csr_array, vstack
from scipy.sparse.linalg import lsmr

from .utils.geometry_numpy import intrinsics_from_fov_numpy, uv_map_numpy
from .utils.tools import timeit

__all__ = ["create_icosahedron_vertices", "extrinsics_look_at", "get_panorama_cameras",
           "spherical_uv_to_directions", "directions_to_spherical_uv", "uv_to_pixel", "remap_bilinear",
           "remap_nearest", "split_panorama_image", "poisson_equation", "grad_equation", "merge_panorama_depth",
           "CG_ITERATIONS"]

CG_MAXITER = 300
CG_TOL = 1e-7
# (width, height) -> CG iterations taken at that merge level, for the last
# merge at that size: filled by ``merge_panorama_depth(solver="cg")`` with one
# readback per level, after its loop
CG_ITERATIONS: Dict[Tuple[int, int], int] = {}


# ---- the camera rig (numpy, copied from the JAX package) ----

def create_icosahedron_vertices() -> np.ndarray:
    """12 unit icosahedron vertices (utils3d `create_icosahedron_mesh`)."""
    phi = (1 + 5 ** 0.5) / 2
    verts = []
    for a in (-1.0, 1.0):
        for b in (-phi, phi):
            verts += [(0, a, b), (a, b, 0), (b, 0, a)]
    verts = np.asarray(verts, np.float32)
    return verts / np.linalg.norm(verts, axis=-1, keepdims=True)


def extrinsics_look_at(eye, target, up) -> np.ndarray:
    """OpenCV-convention world->camera extrinsics, batched over targets."""
    eye = np.asarray(eye, np.float32)
    target = np.atleast_2d(np.asarray(target, np.float32))
    up = np.asarray(up, np.float32)
    z = target - eye
    z = z / np.linalg.norm(z, axis=-1, keepdims=True)
    x = np.cross(z, np.broadcast_to(up, z.shape))
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=-2)  # rows: camera axes in world coords
    t = -(R @ eye.reshape(1, 3, 1) if eye.ndim == 1 else R @ eye[..., None])
    ext = np.concatenate([R, np.broadcast_to(t, (*R.shape[:-1], 1))], axis=-1)
    bottom = np.zeros((*ext.shape[:-2], 1, 4), np.float32)
    bottom[..., 0, 3] = 1
    return np.concatenate([ext, bottom], axis=-2).astype(np.float32)


def get_panorama_cameras() -> Tuple[np.ndarray, List[np.ndarray]]:
    """The 12 icosahedron vertices as view directions, 90-deg FoV each
    (reference panorama.py:20-24)."""
    vertices = create_icosahedron_vertices()
    intrinsics = intrinsics_from_fov_numpy(fov_x=np.deg2rad(90), fov_y=np.deg2rad(90))
    extrinsics = extrinsics_look_at([0, 0, 0], vertices, [0, 0, 1]).astype(np.float32)
    return extrinsics, [intrinsics] * len(vertices)


def spherical_uv_to_directions(uv: np.ndarray) -> np.ndarray:
    theta, phi = (1 - uv[..., 0]) * (2 * np.pi), uv[..., 1] * np.pi
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=-1
    )


def directions_to_spherical_uv(directions: np.ndarray) -> np.ndarray:
    directions = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    u = 1 - np.arctan2(directions[..., 1], directions[..., 0]) / (2 * np.pi) % 1.0
    v = np.arccos(np.clip(directions[..., 2], -1, 1)) / np.pi
    return np.stack([u, v], axis=-1)


def uv_to_pixel(uv: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    h, w = hw[:2]
    return np.stack([uv[..., 0] * w - 0.5, uv[..., 1] * h - 0.5], axis=-1)


def _unproject(uv: np.ndarray, extrinsics: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """uv (H,W,2) at depth 1 -> world directions."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    cam = np.stack([x, y, np.ones_like(x)], axis=-1)
    R = extrinsics[:3, :3]
    return cam @ R  # R^T @ cam, batched


def _project(directions: np.ndarray, extrinsics: np.ndarray, intrinsics: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    R = extrinsics[:3, :3]
    cam = directions @ R.T
    z = cam[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = cam[..., 0] / z * intrinsics[0, 0] + intrinsics[0, 2]
        v = cam[..., 1] / z * intrinsics[1, 1] + intrinsics[1, 2]
    return np.stack([u, v], axis=-1), z


# ---- resampling in torch, matched to cv2.remap with BORDER_REPLICATE ----

def _corners(pixels: torch.Tensor, height: int, width: int):
    """Floor, fraction and the clamped neighbour indices of (..., 2) pixel
    coordinates (x, y), pixel centres at integers as in cv2."""
    x, y = pixels[..., 0], pixels[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    xs = (x0.clamp(0, width - 1), (x0 + 1).clamp(0, width - 1))
    ys = (y0.clamp(0, height - 1), (y0 + 1).clamp(0, height - 1))
    return xs, ys, fx, fy


def _gather(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """image (B, H, W, ...) at per-batch (B, h, w) indices -> (B, h, w, ...)."""
    b = torch.arange(image.shape[0], device=image.device).view(-1, *([1] * (ys.dim() - 1)))
    return image[b, ys, xs]


def remap_bilinear(image: torch.Tensor, pixels: torch.Tensor) -> torch.Tensor:
    """``cv2.remap(image, x, y, INTER_LINEAR, borderMode=BORDER_REPLICATE)``
    per batch entry: ``image`` (B, H, W) or (B, H, W, C), ``pixels`` (B, h,
    w, 2) float32 (x, y) with pixel centres at integers. Exact bilinear
    weights in fp32 (cv2 gives the same for fp32 images); a uint8 image is
    rounded to the nearest level, as cv2 does."""
    height, width = image.shape[1], image.shape[2]
    (x0, x1), (y0, y1), fx, fy = _corners(pixels, height, width)
    src = image.float()
    if src.dim() == 4:
        fx, fy = fx[..., None], fy[..., None]
    top = _gather(src, y0, x0) * (1 - fx) + _gather(src, y0, x1) * fx
    bottom = _gather(src, y1, x0) * (1 - fx) + _gather(src, y1, x1) * fx
    out = top * (1 - fy) + bottom * fy
    if image.dtype == torch.uint8:
        return out.round().clamp(0, 255).to(torch.uint8)
    return out.to(image.dtype)


def remap_nearest(image: torch.Tensor, pixels: torch.Tensor) -> torch.Tensor:
    """``cv2.remap(image, x, y, INTER_NEAREST, borderMode=BORDER_REPLICATE)``
    per batch entry: coordinates rounded half to even (cv2's ``cvRound``),
    then clamped."""
    height, width = image.shape[1], image.shape[2]
    x = torch.round(pixels[..., 0]).long().clamp(0, width - 1)
    y = torch.round(pixels[..., 1]).long().clamp(0, height - 1)
    return _gather(image, y, x)


def _split_pixels(height: int, width: int, extrinsics, intrinsics, resolution: int) -> np.ndarray:
    """(V, R, R, 2) float32 source pixels of every view in the panorama."""
    uv = uv_map_numpy(resolution, resolution)
    out = []
    for i in range(len(extrinsics)):
        directions = _unproject(uv, extrinsics[i], intrinsics[i])
        spherical_uv = directions_to_spherical_uv(directions)
        out.append(uv_to_pixel(spherical_uv, (height, width)).astype(np.float32))
    return np.stack(out)


def split_panorama_image(image: torch.Tensor, extrinsics: np.ndarray, intrinsics: Sequence[np.ndarray],
                         resolution: int) -> torch.Tensor:
    """Resample an equirectangular (H, W, C) image into perspective views
    (reference :40-50): (V, R, R, C) on the image's device, in its dtype.

    Views straddling the u=0/1 seam interpolate across the horizontal wrap
    (one column padded on each side with wrap, coordinates shifted by one),
    as the JAX package does."""
    height, width = image.shape[:2]
    wrapped = torch.cat([image[:, -1:], image, image[:, :1]], dim=1)
    pixels = torch.from_numpy(_split_pixels(height, width, extrinsics, intrinsics, resolution)).to(image.device)
    pixels[..., 0] += 1.0
    views = len(extrinsics)
    return remap_bilinear(wrapped[None].expand(views, *wrapped.shape), pixels)


# ---- the merge ----

def poisson_equation(width: int, height: int, wrap_x: bool = False, wrap_y: bool = False) -> csr_array:
    """5-point Laplacian rows (reference panorama.py:53-69)."""
    grid_index = np.arange(height * width).reshape(height, width)
    grid_index = np.pad(grid_index, ((0, 0), (1, 1)), mode="wrap" if wrap_x else "edge")
    grid_index = np.pad(grid_index, ((1, 1), (0, 0)), mode="wrap" if wrap_y else "edge")

    data = np.array([[-4, 1, 1, 1, 1]], dtype=np.float32).repeat(height * width, axis=0).reshape(-1)
    indices = np.stack([
        grid_index[1:-1, 1:-1],
        grid_index[:-2, 1:-1],
        grid_index[2:, 1:-1],
        grid_index[1:-1, :-2],
        grid_index[1:-1, 2:],
    ], axis=-1).reshape(-1)
    indptr = np.arange(0, height * width * 5 + 1, 5)
    return csr_array((data, indices, indptr), shape=(height * width, height * width))


def grad_equation(width: int, height: int, wrap_x: bool = False, wrap_y: bool = False) -> csr_array:
    """Finite-difference gradient rows (reference panorama.py:72-101)."""
    grid_index = np.arange(width * height).reshape(height, width)
    if wrap_x:
        grid_index = np.pad(grid_index, ((0, 0), (0, 1)), mode="wrap")
    if wrap_y:
        grid_index = np.pad(grid_index, ((0, 1), (0, 0)), mode="wrap")

    data = np.concatenate([
        np.stack([
            np.ones((grid_index.shape[0], grid_index.shape[1] - 1), np.float32).reshape(-1),
            -np.ones((grid_index.shape[0], grid_index.shape[1] - 1), np.float32).reshape(-1),
        ], axis=1).reshape(-1),
        np.stack([
            np.ones((grid_index.shape[0] - 1, grid_index.shape[1]), np.float32).reshape(-1),
            -np.ones((grid_index.shape[0] - 1, grid_index.shape[1]), np.float32).reshape(-1),
        ], axis=1).reshape(-1),
    ])
    indices = np.concatenate([
        np.stack([grid_index[:, :-1].reshape(-1), grid_index[:, 1:].reshape(-1)], axis=1).reshape(-1),
        np.stack([grid_index[:-1, :].reshape(-1), grid_index[1:, :].reshape(-1)], axis=1).reshape(-1),
    ])
    n_rows = grid_index.shape[0] * (grid_index.shape[1] - 1) + (grid_index.shape[0] - 1) * grid_index.shape[1]
    indptr = np.arange(0, n_rows * 2 + 1, 2)
    return csr_array((data, indices, indptr), shape=(n_rows, height * width))


def _wrap_x(u: torch.Tensor, left: int, right: int) -> torch.Tensor:
    return torch.cat([u[..., u.shape[-1] - left:], u, u[..., :right]], dim=-1)


def _edge_y(u: torch.Tensor) -> torch.Tensor:
    return torch.cat([u[..., :1, :], u, u[..., -1:, :]], dim=-2)


def _laplacian(u: torch.Tensor) -> torch.Tensor:
    """5-point Laplacian of (..., h, w) maps: edge-clamped in y, wrapped in x."""
    p = _wrap_x(_edge_y(u), 1, 1)
    return p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2] + p[..., 1:-1, 2:] - 4 * u


def _solve_merge_cg(gx, gy, lap, mgx, mgy, ml, x0, maxiter: int = CG_MAXITER, tol: float = CG_TOL):
    """Conjugate gradient on the merge's normal equations, matrix-free, in
    torch on the device of its inputs (``jax.scipy.sparse.linalg.cg`` of the
    JAX package's ``_solve_merge_cg``, same stencils and stopping rule).

    The rows are (masked) x/y log-distance gradients plus (masked) 5-point
    Laplacians on the equirectangular grid (wrap in x, edge-clamp in y). The
    loop stops at the first iteration where ``r.r <= tol^2 b.b``, or after
    ``maxiter``: that test is evaluated on the device and, once it holds,
    freezes x, r, gamma and p by ``torch.where``, so the loop runs
    ``maxiter`` times without a readback and returns what JAX's while loop
    returns. Returns (x, iterations taken as a 0-d device tensor)."""

    def Gx(u):
        return u - torch.roll(u, -1, dims=1)

    def GxT(r):
        return r - torch.roll(r, 1, dims=1)

    def Gy(u):
        return u[:-1, :] - u[1:, :]

    def GyT(r):
        z = torch.zeros((1, r.shape[1]), dtype=r.dtype, device=r.device)
        return torch.cat([r, z], 0) - torch.cat([z, r], 0)

    def LapT(r):
        z = torch.zeros((1, r.shape[1]), dtype=r.dtype, device=r.device)
        up_t = torch.cat([r[1:], z], 0)
        up_t[0] += r[0]
        dn_t = torch.cat([z, r[:-1]], 0)
        dn_t[-1] += r[-1]
        return -4 * r + up_t + dn_t + torch.roll(r, -1, dims=1) + torch.roll(r, 1, dims=1)

    def ata(u):
        return GxT(mgx * Gx(u)) + GyT(mgy * Gy(u)) + LapT(ml * _laplacian(u))

    b = GxT(mgx * gx) + GyT(mgy * gy) + LapT(ml * lap)
    atol2 = tol * tol * torch.sum(b * b)
    x = x0
    r = b - ata(x)
    p = r
    gamma = torch.sum(r * r)
    taken = torch.zeros((), dtype=torch.int64, device=x.device)
    for _ in range(maxiter):
        active = gamma > atol2
        ap = ata(p)
        alpha = gamma / torch.sum(p * ap)
        x = torch.where(active, x + alpha * p, x)
        r_new = r - alpha * ap
        gamma_new = torch.sum(r_new * r_new)
        p = torch.where(active, r_new + (gamma_new / gamma) * p, p)
        r = torch.where(active, r_new, r)
        gamma = torch.where(active, gamma_new, gamma)
        taken += active
    return x, taken


def _merge_pixels(width: int, height: int, views_hw: Tuple[int, int], extrinsics, intrinsics):
    """Per view, the merge grid's source pixels in the view (V, h, w, 2) and
    where the view sees the grid (V, h, w)."""
    spherical_directions = spherical_uv_to_directions(uv_map_numpy(height, width))
    pixels, valid = [], []
    for i in range(len(extrinsics)):
        projected_uv, projected_depth = _project(spherical_directions, extrinsics[i], intrinsics[i])
        valid.append((projected_depth > 0) & (projected_uv > 0).all(axis=-1) & (projected_uv < 1).all(axis=-1))
        pixels.append(uv_to_pixel(np.clip(projected_uv, 0, 1), views_hw).astype(np.float32))
    return np.stack(pixels), np.stack(valid)


def merge_panorama_depth(
    width: int,
    height: int,
    distance_maps: torch.Tensor,
    pred_masks: torch.Tensor,
    extrinsics: Sequence[np.ndarray],
    intrinsics: Sequence[np.ndarray],
    solver: str = "lsmr",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient-domain merge of per-view distance maps into an equirectangular
    (height, width) depth and mask (reference :105-190). ``distance_maps``
    and ``pred_masks`` are (V, R, R) tensors; the results lie on the device
    of ``distance_maps``.

    ``solver``: "lsmr" = host scipy sparse LSMR (the JAX package's default);
    "cg" = conjugate gradient on the normal equations in torch on the
    device (same system, matrix-free stencils). Above 256 pixels a side the
    solve starts from the 2x coarser merge, upsampled bilinearly. Each
    level's wall time goes to ``timeit.history("panorama merge WxH")``, its
    CG's to ``"panorama cg WxH"``."""
    if solver not in ("lsmr", "cg"):
        raise ValueError(f"unknown merge solver {solver!r}")
    distance_maps = distance_maps.float()
    pred_masks = pred_masks.to(distance_maps.device)
    if max(width, height) > 256:
        init, _ = merge_panorama_depth(width // 2, height // 2, distance_maps, pred_masks, extrinsics, intrinsics,
                                       solver=solver)
    else:
        init = None
    with timeit(f"panorama merge {width}x{height}", verbose=False):
        return _merge_level(width, height, distance_maps, pred_masks, extrinsics, intrinsics, solver, init)


def _merge_level(width: int, height: int, distance_maps: torch.Tensor, pred_masks: torch.Tensor, extrinsics,
                 intrinsics, solver: str, init) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level of ``merge_panorama_depth``, from the coarser level's
    depth ``init`` (or None)."""
    device = distance_maps.device
    if init is not None:
        init = F.interpolate(init[None, None], size=(height, width), mode="bilinear", align_corners=False)[0, 0]
    pixels, valid = _merge_pixels(width, height, tuple(distance_maps.shape[1:3]), extrinsics, intrinsics)
    pixels, valid = torch.from_numpy(pixels).to(device), torch.from_numpy(valid).to(device)
    log_distance = torch.log(torch.clamp_min(distance_maps, 1e-12))
    pano_log = torch.where(valid, remap_bilinear(log_distance, pixels), 0.0)        # (V, h, w)
    pano_mask = valid & (remap_nearest(pred_masks.to(torch.uint8), pixels) > 0)

    padded = _wrap_x(pano_log, 0, 1)
    grad_x, grad_y = padded[..., :, :-1] - padded[..., :, 1:], padded[..., :-1, :] - padded[..., 1:, :]
    padded = _wrap_x(pano_mask, 0, 1)
    mask_x, mask_y = padded[..., :, :-1] & padded[..., :, 1:], padded[..., :-1, :] & padded[..., 1:, :]
    laplacian = _laplacian(pano_log)
    p = _wrap_x(_edge_y(pano_mask), 1, 1)
    lmask = p[..., :-2, 1:-1] & p[..., 2:, 1:-1] & p[..., 1:-1, :-2] & p[..., 1:-1, 2:] & pano_mask

    def view_mean(maps, masks):
        """fp32 sum over the views, divided in fp64 by the count (as numpy
        divides the JAX package's fp32 sums by its integer counts)."""
        m = masks.float()
        return (maps * m).sum(0).double() / torch.clamp_min(m.sum(0).double(), 1e-3)

    gx, gy, lap = view_mean(grad_x, mask_x), view_mean(grad_y, mask_y), view_mean(laplacian, lmask)
    grad_x_mask, grad_y_mask, laplacian_mask = mask_x.any(0), mask_y.any(0), lmask.any(0)

    if solver == "cg":
        x0 = torch.log(init) if init is not None else torch.zeros((height, width), device=device)
        # The y-gradient rows were formed on the x-wrap-padded grid (width+1
        # columns, column `width` == column 0), so in the normal equations a
        # masked duplicate row is exactly a doubled weight on column 0.
        wy = grad_y_mask.float()
        wy_eff = wy[:, :width].clone()
        wy_eff[:, 0] += wy[:, width]
        with timeit(f"panorama cg {width}x{height}", verbose=False):
            x, taken = _solve_merge_cg(gx.float(), gy[:, :width].float(), lap.float(), grad_x_mask.float(), wy_eff,
                                       laplacian_mask.float(), x0)
            CG_ITERATIONS[(width, height)] = int(taken)
        panorama_depth = torch.exp(x)
    else:
        gxm, gym, lm = (m.cpu().numpy().reshape(-1) for m in (grad_x_mask, grad_y_mask, laplacian_mask))
        A = vstack([
            grad_equation(width, height, wrap_x=True, wrap_y=False)[np.concatenate([gxm, gym])],
            poisson_equation(width, height, wrap_x=True, wrap_y=False)[lm],
        ])
        b = np.concatenate([
            gx.cpu().numpy().reshape(-1)[gxm],
            gy.cpu().numpy().reshape(-1)[gym],
            lap.cpu().numpy().reshape(-1)[lm],
        ])
        x0 = torch.log(init).cpu().numpy().reshape(-1) if init is not None else None
        x, *_ = lsmr(A, b, atol=1e-5, btol=1e-5, x0=x0, show=False)
        panorama_depth = torch.from_numpy(np.exp(x).reshape(height, width).astype(np.float32)).to(device)
    return panorama_depth, pano_mask.any(0)
