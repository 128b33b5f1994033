"""Geometrically consistent simulated driving scenes (the port's own copy
of `jperceiver_tpu/data/simulated.py`; samples in the port's layout:
frames (F, 3, H, W), SDF maps (C-1, S, S)).

Renders a textured ground plane (camera height 1.73 m, the KITTI CGT
constant) plus a far wall, viewed from a camera translating forward along
+z. Because the three frames are true projections of one static scene,
the photometric reprojection loss is minimized ONLY by the correct depth
map and ego-motion, and the CGT scale label equals the true metric depth
of ground pixels — so a short training run on these scenes validates the
entire self-supervised pipeline end to end, with analytic ground truth to
check against. No real dataset required.
"""

from __future__ import annotations

import numpy as np

CAMERA_HEIGHT = 1.73  # must match the CGT constant for split='odometry'
ARGO_CAMERA_HEIGHT = 0.33  # the CGT constant for split='argo' (`net.py:257-260`)
WALL_Z = 38.0
STEP_M = 1.0  # per-frame forward motion (enough parallax to avoid the
# automask identity-collapse on low-motion scenes)

VEHICLE_COLOR = np.array([0.85, 0.12, 0.10], np.float32)


def _scene_vehicles(rng, n: int = 3, cam_height: float = CAMERA_HEIGHT):
    """n world-space vehicle footprints (x0, x1, z0, z1) on the ground.

    Painted flat on the ground plane: the vehicle base sits AT ground
    height, which is exactly the assumption the reference's dynamic CGT
    label makes when it warps the vehicle BEV GT through the ground-plane
    homography (`net.py:380-476`) — so the rendered geometry stays
    consistent with the scale supervision. A low camera (Argoverse's
    0.33 m) compresses distant ground into a few image rows, so the
    placement range shrinks with camera height to keep footprints visible.
    """
    z_far = 8.0 + 24.0 * min(1.0, cam_height / CAMERA_HEIGHT)
    rects = []
    for _ in range(n):
        cz = rng.uniform(4.0, z_far)
        cx = rng.uniform(-0.45, 0.45) * cz  # keep inside the view frustum
        half_w = rng.uniform(0.9, 1.2)
        half_l = rng.uniform(1.8, 2.4)
        rects.append((cx - half_w, cx + half_w, cz - half_l, cz + half_l))
    return rects


def _texture(rng, size=512, octaves=3):
    """Smooth-but-contrasty random RGB texture, wrap-around sampling."""
    tex = np.zeros((size, size, 3), np.float32)
    for o in range(octaves):
        n = size >> (octaves - 1 - o)
        # keep the finest octave coarse (>= 8 texels/feature) so distant
        # ground pixels (large texel footprints) do not alias into noise
        layer = rng.uniform(0, 1, (max(4, n // 16), max(4, n // 16), 3)).astype(np.float32)
        n = layer.shape[0]
        # bilinear upsample to full size with wraparound
        idx = np.linspace(0, n, size, endpoint=False)
        i0 = np.floor(idx).astype(int) % n
        i1 = (i0 + 1) % n
        w = (idx - np.floor(idx)).astype(np.float32)
        up = (
            layer[i0][:, i0] * (1 - w)[None, :, None] * (1 - w)[:, None, None]
            + layer[i0][:, i1] * w[None, :, None] * (1 - w)[:, None, None]
            + layer[i1][:, i0] * (1 - w)[None, :, None] * w[:, None, None]
            + layer[i1][:, i1] * w[None, :, None] * w[:, None, None]
        )
        tex += up * (0.5 ** (octaves - 1 - o))
    tex -= tex.min()
    tex /= tex.max() + 1e-6
    return tex


def _sample_tex(tex, u, v, scale=6.0):
    """Wrap-around bilinear sample of tex at world coords (u, v) meters."""
    size = tex.shape[0]
    x = (u * scale) % size
    y = (v * scale) % size
    x0 = np.floor(x).astype(int) % size
    y0 = np.floor(y).astype(int) % size
    x1 = (x0 + 1) % size
    y1 = (y0 + 1) % size
    wx = (x - np.floor(x))[..., None]
    wy = (y - np.floor(y))[..., None]
    return (
        tex[y0, x0] * (1 - wx) * (1 - wy)
        + tex[y0, x1] * wx * (1 - wy)
        + tex[y1, x0] * (1 - wx) * wy
        + tex[y1, x1] * wx * wy
    )


def render_frame(tex_ground, tex_wall, K3, height, width, cam_z,
                 wall_z: float | None = None,
                 cam_height: float = CAMERA_HEIGHT,
                 vehicles=()):
    """Render the scene from camera position (0, 0, cam_z); returns
    (image (H,W,3), gt_depth (H,W)). `wall_z` overrides the far-wall
    position (long odometry sequences park it beyond the drive length so
    the camera never reaches it). `vehicles` is a list of world-space
    footprint rects (x0, x1, z0, z1) painted onto the ground plane."""
    fx, fy = K3[0, 0], K3[1, 1]
    cx, cy = K3[0, 2], K3[1, 2]
    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    up = (us - cx) / fx
    vp = (vs - cy) / fy

    if wall_z is None:
        wall_z = WALL_Z
    wall_depth = wall_z - cam_z  # the wall is at world z, so it parallaxes
    eps = cam_height / wall_depth
    ground = vp > eps
    depth = np.where(ground, cam_height / np.maximum(vp, 1e-6), wall_depth)

    x_w = up * depth
    z_w = cam_z + depth
    y_wall = vp * depth  # height on the wall plane

    img_ground = _sample_tex(tex_ground, x_w, z_w)
    img_wall = _sample_tex(tex_wall, x_w, y_wall, scale=3.0)
    img = np.where(ground[..., None], img_ground, img_wall)
    for x0, x1, z0, z1 in vehicles:
        # World-anchored (x_w/z_w), so the paint is photometrically
        # consistent across the 3 frames of a scene.
        m = ground & (x_w >= x0) & (x_w <= x1) & (z_w >= z0) & (z_w <= z1)
        img = np.where(m[..., None], 0.3 * img + 0.7 * VEHICLE_COLOR, img)
    return img.astype(np.float32), depth.astype(np.float32)


def scene_calib(height: int, width: int):
    """(K, inv_K, Tr_cam2_velo) of the rendered camera."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.9 * width
    K[0, 2] = width / 2.0
    K[1, 2] = height / 2.0
    inv_K = np.linalg.inv(K).astype(np.float32)
    # cam <- ego(z-up): x_c=-y_e, y_c=-z_e, z_c=x_e — the canonical KITTI
    # permutation with zero offset, consistent with the rendered geometry.
    Tr = np.array(
        [[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float32
    )
    return K, inv_K, Tr


def render_scene(scene_seed: int, height=256, width=256,
                 model_type: str = "static", split: str = "odometry"):
    """One consistent 3-frame scene + analytic GT (no batch dim).

    Returns (sample, gt): sample has the training-batch key schema
    (per-sample shapes), gt = {"depth": (H,W), "T_fwd": (4,4)}.
    The intrinsics ARE the render intrinsics (unlike KITTI's normalized-K
    convention) so the photometric geometry is exact.

    `model_type` in {dynamic, Argo_dynamic, Argo_both} adds painted
    vehicle footprints (and a matching `bev_dynamic` label); `split`
    selects the camera height the CGT label synthesis assumes (1.73 m
    KITTI / 0.33 m Argoverse, `net.py:257-260`).
    """
    occ = height // 4
    K, inv_K, Tr = scene_calib(height, width)
    cam_height = ARGO_CAMERA_HEIGHT if split == "argo" else CAMERA_HEIGHT
    vehicles = (
        _scene_vehicles(np.random.default_rng(scene_seed + 77),
                        cam_height=cam_height)
        if model_type in ("dynamic", "Argo_dynamic", "Argo_both") else ()
    )

    tex_g = _texture(np.random.default_rng(scene_seed))
    tex_w = _texture(np.random.default_rng(scene_seed + 31))
    color = np.zeros((3, height, width, 3), np.float32)
    gt_depth = np.zeros((height, width), np.float32)
    for i, f in enumerate((0, -1, 1)):
        img, depth = render_frame(tex_g, tex_w, K, height, width,
                                  cam_z=f * STEP_M, cam_height=cam_height,
                                  vehicles=vehicles)
        color[i] = img
        if f == 0:
            gt_depth = depth
    # ground truth cam0 -> cam(+1): the new camera is STEP_M ahead, so
    # points move by -STEP_M in the new camera's z.
    T_fwd = np.eye(4, dtype=np.float32)
    T_fwd[2, 3] = -STEP_M

    # BEV static label over the 40 m x +/-20 m window (row 0 = far, like
    # the KITTI labels / `cgt.py` depth ramp): ground plane = road up to
    # the wall at WALL_Z; the band beyond it is non-road, so the label
    # carries BOTH classes (the eval metrics index class 1 of GT-observed
    # classes) and the CGT ramp never claims ground depth on wall cells.
    rows = np.arange(occ, dtype=np.float32)
    row_depth = (occ - rows) * (40.0 / occ)
    bev = np.broadcast_to(
        (row_depth <= WALL_Z).astype(np.float32)[:, None], (occ, occ)
    ).copy()
    # Vehicle footprints rasterized in the same BEV convention (row 0 =
    # far, 40 m window; col c <-> lateral x = (c - occ/2) * 40/occ).
    veh_bev = np.zeros((occ, occ), np.float32)
    for x0, x1, z0, z1 in vehicles:
        r0 = int(np.clip(np.floor(occ - z1 * occ / 40.0), 0, occ))
        r1 = int(np.clip(np.ceil(occ - z0 * occ / 40.0), 0, occ))
        c0 = int(np.clip(np.floor(x0 * occ / 40.0 + occ / 2), 0, occ))
        c1 = int(np.clip(np.ceil(x1 * occ / 40.0 + occ / 2), 0, occ))
        veh_bev[r0:r1, c0:c1] = 1.0
    from ..ops.sdf import signed_distance_field

    color = np.ascontiguousarray(color.transpose(0, 3, 1, 2))
    sample = {
        "color": color,
        "color_aug": color.copy(),
        "K": K,
        "inv_K": inv_K,
        "odometry_K": K.copy(),
        "Tr_cam2_velo": Tr,
        "bev_static": bev,
        "bev_dynamic": veh_bev,
        "bev_both": bev.copy(),  # vehicles sit on the road: union == road
        "bev_static_sdf": signed_distance_field(bev.astype(np.int32), 2),
        "bev_dynamic_sdf": (
            signed_distance_field(veh_bev.astype(np.int32), 2)
            if vehicles else np.zeros((1, occ, occ), np.float32)),
    }
    return sample, {"depth": gt_depth, "T_fwd": T_fwd}


def simulated_batch(batch=2, height=256, width=256, seed=0):
    """A training batch of consistent 3-frame scenes + analytic GT.

    Returns (batch_dict, gt) with gt = {"depth": (B,H,W), "T_fwd": (B,4,4)}.
    """
    samples, gts = zip(*(render_scene(seed * 97 + b, height, width)
                         for b in range(batch)))
    out = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    return out, {k: np.stack([g[k] for g in gts]) for k in gts[0]}


class SimulatedDataset:
    """Loader-pluggable simulated scenes (`get_dataset` name="simulated").

    Gives the full Trainer/EvalHook pipeline a real dataset with analytic
    ground truth and no external data: `__getitem__` renders (and caches)
    one scene; `with_gt=True` adds the `gt_depth` key the eval hook pops.
    Train/val instances must use disjoint `seed`s.
    """

    def __init__(self, n_scenes: int = 64, height: int = 256,
                 width: int = 256, seed: int = 0, with_gt: bool = False,
                 cache: bool = True, model_type: str = "static",
                 split: str = "odometry"):
        self.n_scenes = int(n_scenes)
        self.height, self.width = height, width
        self.seed = seed
        self.with_gt = with_gt
        self.model_type = model_type
        self.split = split
        self._cache: dict[int, dict] | None = {} if cache else None

    def __len__(self) -> int:
        return self.n_scenes

    def __getitem__(self, i: int) -> dict:
        if not 0 <= i < self.n_scenes:
            raise IndexError(i)
        if self._cache is not None and i in self._cache:
            # Shallow copy: consumers that pop/overwrite keys must not
            # corrupt the cache for later epochs (arrays stay shared).
            return dict(self._cache[i])
        sample, gt = render_scene(self.seed * 100003 + i,
                                  self.height, self.width,
                                  model_type=self.model_type,
                                  split=self.split)
        if self.with_gt:
            sample = dict(sample, gt_depth=gt["depth"])
        if self._cache is not None:
            self._cache[i] = sample
            return dict(sample)
        return sample
