"""Visualisation and mesh export (counterpart of gator_tpu/vis.py;
reference: lib/vis.py, demo/renderer.py, lib/funcs_utils.py:51-57,
130-150): 2D keypoint overlays (cv2), the 3D pose plot and the loss curve
(matplotlib), Wavefront .obj export, and the mesh overlay renderers.

All of it is host numpy. cv2, matplotlib, pyrender and trimesh are optional
and imported inside the functions that draw with them.
`render_mesh_overlay(backend="auto")` renders with
pyrender where it imports (the reference's offscreen EGL path) and
otherwise with the software z-buffer rasteriser here, as the JAX package
does: a choice of renderer for an image, not a fallback of any
computation.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def save_obj(verts: np.ndarray, faces: np.ndarray, path: str):
    """Write [V, 3] vertices and [F, 3] 0-based faces as Wavefront .obj."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:f} {v[1]:f} {v[2]:f}\n")
        for face in faces + 1:   # 1-indexed
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def vis_2d_keypoints(img: np.ndarray, kps: np.ndarray,
                     skeleton: Sequence[Sequence[int]],
                     kp_thresh: float = 0.4,
                     alpha: float = 1.0) -> np.ndarray:
    """Draw a 2D skeleton over an image. kps: [3, K] (x, y, score)
    (reference: lib/vis.py:77-115)."""
    import cv2

    cmap_idx = np.linspace(0, 255, len(skeleton) + 2).astype(np.uint8)
    colors = [tuple(int(c) for c in cv2.applyColorMap(
        np.array([[i]], np.uint8), cv2.COLORMAP_RAINBOW)[0, 0])
        for i in cmap_idx]
    canvas = img.copy()
    for i, (a, b) in enumerate(skeleton):
        pa = (int(kps[0, a]), int(kps[1, a]))
        pb = (int(kps[0, b]), int(kps[1, b]))
        if kps[2, a] > kp_thresh and kps[2, b] > kp_thresh:
            cv2.line(canvas, pa, pb, colors[i], 2, cv2.LINE_AA)
        if kps[2, a] > kp_thresh:
            cv2.circle(canvas, pa, 3, colors[i], -1, cv2.LINE_AA)
        if kps[2, b] > kp_thresh:
            cv2.circle(canvas, pb, 3, colors[i], -1, cv2.LINE_AA)
    return cv2.addWeighted(img, 1.0 - alpha, canvas, alpha, 0)


def vis_3d_pose(joints: np.ndarray, skeleton, path: str,
                elev: float = 10.0, azim: float = -90.0):
    """3D pose plot to a PNG (reference: lib/vis.py:144+)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    for a, b in skeleton:
        ax.plot([joints[a, 0], joints[b, 0]],
                [joints[a, 2], joints[b, 2]],
                [-joints[a, 1], -joints[b, 1]], "b-", lw=2)
    ax.scatter(joints[:, 0], joints[:, 2], -joints[:, 1], c="r", s=8)
    ax.view_init(elev=elev, azim=azim)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_loss_plot(values, path: str, title: str = "Train Loss") -> bool:
    """Plot the per-epoch loss curve to `path` -> True, or, where
    matplotlib is not installed (the card's machine has none), write
    nothing and -> False. The plot is a convenience: the same history is
    in every checkpoint's `train_log`. This is a missing optional
    dependency, not a fallback of any computation."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot(np.arange(1, len(values) + 1), values)
    ax.set_xlabel("epoch")
    ax.set_title(title)
    fig.savefig(path)
    plt.close(fig)
    return True


def pyrender_available() -> bool:
    # the EGL selection must precede the FIRST pyrender/PyOpenGL import —
    # OpenGL picks its platform at import time (reference sets it at
    # module top: demo/renderer.py:1-2)
    import os as _os
    _os.environ.setdefault("PYOPENGL_PLATFORM", "egl")
    try:
        import pyrender  # noqa: F401
        import trimesh   # noqa: F401
        return True
    except Exception:
        return False


def render_mesh_overlay_pyrender(img: np.ndarray, verts: np.ndarray,
                                 faces: np.ndarray, orig_cam: np.ndarray,
                                 color=(0.65, 0.74, 0.86)) -> np.ndarray:
    """Hardware-rendered overlay via pyrender, mirroring the reference's
    offscreen EGL path: weak-perspective projection matrix
    diag(sx, sy, -1) with [tx*sx, -ty*sy] translation, a 180-deg X flip of
    the mesh, two 45-deg directional lights, RGBA render composited over
    the image where depth > 0 (reference: demo/renderer.py:13-115).
    Requires pyrender + trimesh; call pyrender_available() first or use
    render_mesh_overlay(backend='auto')."""
    import os as _os
    _os.environ.setdefault("PYOPENGL_PLATFORM", "egl")
    import pyrender
    import trimesh
    from pyrender.constants import RenderFlags

    h, w = img.shape[:2]
    sx, sy, tx, ty = (float(v) for v in orig_cam)

    class _WeakPerspectiveCamera(pyrender.Camera):
        def get_projection_matrix(self, width=None, height=None):
            p = np.eye(4)
            p[0, 0] = sx
            p[1, 1] = sy
            p[0, 3] = tx * sx
            p[1, 3] = -ty * sy
            p[2, 2] = -1
            return p

    mesh = trimesh.Trimesh(vertices=np.asarray(verts, np.float64),
                           faces=np.asarray(faces), process=False)
    mesh.apply_transform(trimesh.transformations.rotation_matrix(
        np.pi, [1, 0, 0]))
    scene = pyrender.Scene(bg_color=[0.0, 0.0, 0.0, 0.0],
                           ambient_light=(0.3, 0.3, 0.3))
    light = pyrender.DirectionalLight(color=[1.0, 1.0, 1.0], intensity=1.2)
    scene.add(light, pose=trimesh.transformations.rotation_matrix(
        np.radians(-45), [1, 0, 0]))
    scene.add(light, pose=trimesh.transformations.rotation_matrix(
        np.radians(45), [0, 1, 0]))
    material = pyrender.MetallicRoughnessMaterial(
        metallicFactor=0.0, alphaMode="OPAQUE", baseColorFactor=color)
    scene.add(pyrender.Mesh.from_trimesh(mesh, material=material), "mesh")
    scene.add(_WeakPerspectiveCamera(znear=pyrender.camera.DEFAULT_Z_NEAR,
                                     zfar=1000.0), pose=np.eye(4))
    renderer = pyrender.OffscreenRenderer(viewport_width=w,
                                          viewport_height=h, point_size=1.0)
    try:
        rgb, depth = renderer.render(scene, flags=RenderFlags.RGBA)
    finally:
        renderer.delete()
    mask = (depth > 0)[:, :, None]
    out = rgb[:, :, :3] * mask + (1 - mask) * img
    return out.astype(np.uint8)


def render_mesh_overlay(img: np.ndarray, verts: np.ndarray,
                        faces: np.ndarray, orig_cam: np.ndarray,
                        color=(0.65, 0.74, 0.86),
                        backend: str = "auto") -> np.ndarray:
    """Mesh-over-image render with a weak-perspective NDC camera
    [sx, sy, tx, ty] (same camera convention as the reference's pyrender
    path — demo/renderer.py:13-35).

    backend: 'auto' uses pyrender when importable (the reference's
    renderer), otherwise the dependency-free software z-buffer rasterizer;
    'pyrender' / 'software' force one."""
    if backend not in ("auto", "pyrender", "software"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "pyrender" or (backend == "auto" and
                                 pyrender_available()):
        return render_mesh_overlay_pyrender(img, verts, faces, orig_cam,
                                            color)
    h, w = img.shape[:2]
    sx, sy, tx, ty = orig_cam
    # NDC -> pixels
    x = (verts[:, 0] + tx) * sx
    y = (verts[:, 1] + ty) * sy
    px = (x + 1.0) * 0.5 * w
    py = (y + 1.0) * 0.5 * h
    z = verts[:, 2]
    pts = np.stack([px, py, z], axis=1)

    out = img.astype(np.float32).copy()
    zbuf = np.full((h, w), np.inf, np.float32)
    tri = pts[faces]                                   # [F, 3, 3]
    # backface/degenerate culling + painter-ish shading
    v1 = tri[:, 1, :2] - tri[:, 0, :2]
    v2 = tri[:, 2, :2] - tri[:, 0, :2]
    area = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]
    normal3 = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nz = normal3[:, 2] / (np.linalg.norm(normal3, axis=1) + 1e-9)
    shade = 0.35 + 0.65 * np.clip(-nz, 0, 1)
    order = np.argsort(-tri[:, :, 2].mean(1))          # far to near
    base = np.array(color, np.float32) * 255.0
    for fi in order:
        if abs(area[fi]) < 1e-9:
            continue
        t = tri[fi]
        x0, x1 = int(max(0, np.floor(t[:, 0].min()))), int(
            min(w - 1, np.ceil(t[:, 0].max())))
        y0, y1 = int(max(0, np.floor(t[:, 1].min()))), int(
            min(h - 1, np.ceil(t[:, 1].max())))
        if x1 < x0 or y1 < y0:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        d = np.stack([xs - t[0, 0], ys - t[0, 1]], axis=-1)
        denom = area[fi]
        wb = (d[..., 0] * v2[fi, 1] - d[..., 1] * v2[fi, 0]) / denom
        wc = (d[..., 1] * v1[fi, 0] - d[..., 0] * v1[fi, 1]) / denom
        wa = 1.0 - wb - wc
        inside = (wa >= 0) & (wb >= 0) & (wc >= 0)
        if not inside.any():
            continue
        zi = wa * t[0, 2] + wb * t[1, 2] + wc * t[2, 2]
        sub_z = zbuf[y0:y1 + 1, x0:x1 + 1]
        upd = inside & (zi < sub_z)
        sub_z[upd] = zi[upd]
        sub = out[y0:y1 + 1, x0:x1 + 1]
        sub[upd] = 0.25 * sub[upd] + 0.75 * shade[fi] * base
    return np.clip(out, 0, 255).astype(np.uint8)
