"""Procedural face-family generator: parameterized head geometry + albedo.

FaceScape is license-gated (SURVEY.md section 7 "Parity validation without
FaceScape"), so the morphable capability — ONE model spanning many
identities x expressions through conditioning codes (the reference's entire
point: run_train.py:114-116, configs/exp_mofanerf.txt person_num=300) — is
demonstrated on a procedurally generated family of face-LIKE heads:

- Each identity is a point `p` in a 10-dim parameter space controlling head
  proportions, nose, eyes, mouth, cheeks, brow, and skin tone. The identity
  parameters ARE the first dims of the 50-dim shape code, so the
  code -> geometry map is smooth by construction and identity interpolation
  sweeps are meaningful (the analog of FaceScape's bilinear identity
  factors, factors_id.npy).
- Expressions are shared deformations on 8 axes (jaw/smile/brow/shift/
  pucker/cheek/eye/fwd) applied on top of any identity; all 20 FaceScape
  expression ids ship with distinct axis combinations (EXPRESSION_PARAMS) —
  the analog of FaceScape's 20 expression scans driving the learned
  expression latents (reference models/render_class.py:53-58).
- Geometry: a lat-long sphere displaced by anisotropic angular Gaussian
  features; albedo: skin tone + lip/eye/brow recoloring from the same
  feature masks; the UV texture map is the spherical unwrap of that albedo
  (so the texture encoder sees a per-identity image whose content actually
  predicts the rendered colors).
- 68 approximate landmarks per (identity, expression) in the standard
  jaw/brow/nose/eyes/mouth layout feed the landmark-biased ray sampler
  (reference run_train.py:119-148).

Everything is numpy host-side data production (datagen layer, a copy of
mofanerf_tpu/datagen/synthetic_faces.py); rendering goes through the port's
rasterizer (datagen/rasterize.py) on the card. The UV maps are written by the
port's baseline JPEG encoder (quality 75, 4:4:4), where the JAX package's
Pillow writes 4:2:0: the decoded maps differ by JPEG noise.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np

N_ID_PARAMS = 10
SHAPE_CODE_DIM = 50

# Expression axes. Each expression id maps to a point on these 8 deformation
# axes; ids follow the reference's FaceScape semantics
# (data/facescape.py EXPRESSION_NAMES; the reference trains ONE latent per
# id, models/render_class.py:53-58). Axes:
#   jaw    [0..1]  jaw open (mouth taller, chin drops, head elongates)
#   smile  [-1..1] mouth corners up (+) / down (-), mouth widens with +
#   brow   [-1..1] brows raised (+) / lowered+furrowed (-)
#   shift  [-1..1] lateral jaw/mouth shift (- = subject's left)
#   pucker [-1..1] lips puckered/protruding (+) / rolled thin (-)
#   cheek  [0..1]  cheeks blown out
#   eye    [0..1]  eyes closed (sockets smooth out, eye color fades to skin)
#   fwd    [0..1]  jaw/chin thrust forward
# Expressions 0/1/2/18 keep the exact values the round-3 datasets were
# generated with (new axes are constructed to vanish at 0, so those four
# meshes are bit-identical to the 3-axis model).
EXP_AXES = ("jaw", "smile", "brow", "shift", "pucker", "cheek", "eye", "fwd")

EXPRESSION_PARAMS: Dict[int, Tuple[float, ...]] = {
    #    jaw  smile  brow shift pucker cheek  eye  fwd
    0:  (0.0,  0.0,  0.0,  0.0,  0.0,  0.0,  0.0, 0.0),   # neutral
    1:  (0.15, 1.0,  0.35, 0.0,  0.0,  0.0,  0.0, 0.0),   # smile
    2:  (1.0,  0.0,  0.15, 0.0,  0.0,  0.0,  0.0, 0.0),   # mouth_stretch
    3:  (0.1, -0.6, -1.0,  0.0,  0.0,  0.0,  0.2, 0.0),   # anger
    4:  (0.35, 0.0,  0.0, -1.0,  0.0,  0.0,  0.0, 0.0),   # jaw_left
    5:  (0.35, 0.0,  0.0,  1.0,  0.0,  0.0,  0.0, 0.0),   # jaw_right
    6:  (0.25, 0.0,  0.0,  0.0,  0.0,  0.0,  0.0, 1.0),   # jaw_forward
    7:  (0.05, 0.2,  0.0, -0.8,  0.0,  0.0,  0.0, 0.0),   # mouth_left
    8:  (0.05, 0.2,  0.0,  0.8,  0.0,  0.0,  0.0, 0.0),   # mouth_right
    9:  (0.05, 0.7,  0.0,  0.0, -0.8,  0.0,  0.0, 0.0),   # dimpler
    10: (0.0, -0.3,  0.0,  0.0,  0.3,  0.0,  0.0, 0.6),   # chin_raiser
    11: (0.1,  0.0,  0.0,  0.0,  1.0,  0.0,  0.0, 0.0),   # lip_puckerer
    12: (0.45, 0.0,  0.0,  0.0,  0.8,  0.0,  0.0, 0.0),   # lip_funneler
    13: (0.05, -1.0, 0.25, 0.0,  0.0,  0.0,  0.15, 0.0),  # sadness
    14: (0.05, 0.0,  0.0,  0.0, -1.0,  0.0,  0.0, 0.0),   # lip_roll
    15: (0.1,  0.8,  0.1,  0.0, -0.6,  0.0,  0.0, 0.0),   # grin
    16: (0.05, 0.0,  0.0,  0.0,  0.5,  1.0,  0.0, 0.0),   # cheek_blowing
    17: (0.0,  0.0, -0.1,  0.0,  0.0,  0.0,  1.0, 0.0),   # eye_closed
    18: (0.0,  0.1,  1.0,  0.0,  0.0,  0.0,  0.0, 0.0),   # brow_raiser
    19: (0.05, -0.1, -1.0, 0.0,  0.0,  0.0,  0.3, 0.0),   # brow_lower
}


def _exp_vec(e) -> np.ndarray:
    """Normalize an expression spec (id already resolved to a tuple) to the
    8-axis vector; legacy 3-tuples (jaw, smile, brow) pad with zeros."""
    v = np.zeros(len(EXP_AXES), np.float64)
    e = np.asarray(e, np.float64).reshape(-1)
    v[: e.shape[0]] = e
    return v

_HEAD_RADIUS = 2.0  # world units (head diameter ~4 = 200 mm / 50, the
                    # reference world scale, run_fit.py:142 scale=50)


def sample_identity_params(n: int, seed: int = 0) -> np.ndarray:
    """[n, N_ID_PARAMS] identity parameters, U(-1, 1)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (n, N_ID_PARAMS)).astype(np.float32)


def shape_code_from_params(p: np.ndarray) -> np.ndarray:
    """Identity params -> 50-dim shape code (params occupy the leading
    dims; the rest are zero). Linear, so code interpolation == parameter
    interpolation."""
    p = np.asarray(p, np.float32)
    code = np.zeros(p.shape[:-1] + (SHAPE_CODE_DIM,), np.float32)
    code[..., : p.shape[-1]] = p
    return code


def _gauss(a, a0, wa, b, b0, wb):
    """Anisotropic angular Gaussian on (azimuth a, elevation b)."""
    return np.exp(-0.5 * (((a - a0) / wa) ** 2 + ((b - b0) / wb) ** 2))


def _feature_fields(a: np.ndarray, b: np.ndarray, p: np.ndarray, e) -> dict:
    """Evaluate the displacement + color-mask fields at angular coords.

    a: azimuth about +y measured from +z (front), b: elevation.
    p: [N_ID_PARAMS]; e: expression on the EXP_AXES (3-tuples pad to 0).
    Returns dict with 'bump' (radial multiplier delta) and per-feature
    color masks. Every expression term vanishes at axis value 0, so the
    legacy (jaw, smile, brow) triples reproduce the round-3 fields
    exactly."""
    jaw, smile, brow_raise, shift, pucker, cheek, eye, fwd = _exp_vec(e)

    nose = _gauss(a, 0.0, 0.22 * (1 + 0.3 * p[4]), b, -0.08, 0.26)
    eye_sp = 0.42 * (1 + 0.25 * p[6])
    eye_open = 1.0 - 0.85 * eye
    eyes = _gauss(a, eye_sp, 0.16, b, 0.30, 0.12) + _gauss(a, -eye_sp, 0.16, b, 0.30, 0.12)
    # r5: lateral shift / pucker / lip-roll amplitudes raised ~1.7x — at
    # 128^2 the round-4 deltas for mouth_left/right, lip_puckerer and
    # lip_roll were too subtle for the expression codes to be identifiable
    # (morphable16x20.json round-4: wrong >= own on 8/20 exps). These axes
    # are all ZERO in the legacy expressions 0/1/2/18, so existing datasets
    # stay bit-identical.
    a_m = 0.30 * shift                       # lateral mouth/jaw center
    mouth_w = ((0.34 * (1 + 0.25 * p[7]) + 0.14 * smile)
               * (1 - 0.45 * max(pucker, 0.0)) * (1 - 0.25 * cheek))
    mouth_h = (0.10 + 0.14 * jaw) * (1 - 0.45 * max(-pucker, 0.0))
    mouth = _gauss(a, a_m, mouth_w, b, -0.50, mouth_h)
    corners = (_gauss(a, a_m + mouth_w, 0.10, b, -0.46, 0.08)
               + _gauss(a, a_m - mouth_w, 0.10, b, -0.46, 0.08))
    lips = _gauss(a, a_m, max(mouth_w * 0.7, 0.10), b, -0.50, 0.10)
    brow_b = 0.50 + 0.05 * brow_raise
    brows = (_gauss(a, eye_sp, 0.22, b, brow_b, 0.07)
             + _gauss(a, -eye_sp, 0.22, b, brow_b, 0.07))
    furrow = _gauss(a, 0.0, 0.12, b, 0.42, 0.10)
    cheeks = (_gauss(a, 0.70, 0.26, b, -0.12, 0.22)
              + _gauss(a, -0.70, 0.26, b, -0.12, 0.22))
    chin = _gauss(a, 0.10 * shift, 0.30, b, -0.95, 0.28)

    bump = (
        0.30 * (1 + 0.40 * p[3]) * nose
        - 0.10 * (1 + 0.50 * p[5]) * eye_open * eyes
        + 0.06 * eye * eyes                       # closed-lid bulge
        - (0.07 + 0.18 * jaw) * mouth
        + 0.10 * smile * corners
        + 0.30 * pucker * lips
        + 0.06 * (1 + 0.6 * p[9] + 1.4 * brow_raise) * brows
        + 0.22 * max(-brow_raise, 0.0) * furrow
        + (0.09 * (0.5 + 0.5 * p[8]) + 0.22 * cheek) * cheeks
        + (0.06 + 0.16 * jaw + 0.18 * fwd) * chin
    )
    return {"bump": bump, "nose": nose, "eyes": eyes * eye_open,
            "mouth": mouth, "brows": brows, "cheeks": cheeks}


def _albedo_at(a: np.ndarray, b: np.ndarray, p: np.ndarray, e) -> np.ndarray:
    """Per-point RGB albedo from the feature masks: identity skin tone with
    lip / eye / brow recoloring."""
    f = _feature_fields(a, b, p, e)
    ev = _exp_vec(e)
    skin = np.array([
        0.72 + 0.08 * p[0], 0.55 + 0.07 * p[1], 0.45 + 0.06 * p[2]
    ], np.float32)
    albedo = np.broadcast_to(skin, a.shape + (3,)).copy()

    def mix(mask, color, strength=1.0):
        w = np.clip(mask * strength, 0.0, 1.0)[..., None]
        return (1 - w) * albedo + w * np.asarray(color, np.float32)

    # lips saturate with pucker / fade when rolled thin (vanishes at 0, so
    # legacy expressions keep their exact colors)
    lip_strength = 1.2 + 0.8 * max(ev[4], 0.0) - 0.6 * max(-ev[4], 0.0)
    albedo = mix(f["mouth"], (0.62 + 0.1 * p[7], 0.25, 0.28), lip_strength)
    albedo = mix(f["eyes"], (0.16, 0.22, 0.30 + 0.1 * p[5]), 1.4)
    albedo = mix(f["brows"], (0.25 + 0.1 * p[9], 0.17, 0.12), 1.2)
    albedo = mix(f["cheeks"] * 0.4, (0.80, 0.45, 0.42), 0.8)
    return np.clip(albedo, 0.0, 1.0)


def _sphere_topology(n_lat: int, n_lon: int):
    """Lat-long grid + polar caps. Returns (dirs [V,3], faces [F,3],
    (a, b) angular coords [V])."""
    us = np.linspace(0.0, np.pi, n_lat + 2)[1:-1]          # polar angle
    vs = np.linspace(-np.pi, np.pi, n_lon, endpoint=False)  # azimuth from +z
    uu, vv = np.meshgrid(us, vs, indexing="ij")             # [n_lat, n_lon]
    y = np.cos(uu)
    x = np.sin(uu) * np.sin(vv)
    z = np.sin(uu) * np.cos(vv)
    dirs = np.stack([x, y, z], -1).reshape(-1, 3)
    # poles
    dirs = np.concatenate([dirs, [[0, 1, 0]], [[0, -1, 0]]], 0)
    top, bot = n_lat * n_lon, n_lat * n_lon + 1

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            q = (vid(i, j), vid(i, j + 1), vid(i + 1, j + 1), vid(i + 1, j))
            faces.append((q[0], q[2], q[1]))
            faces.append((q[0], q[3], q[2]))
    for j in range(n_lon):  # polar fans
        faces.append((top, vid(0, j), vid(0, j + 1)))
        faces.append((bot, vid(n_lat - 1, j + 1), vid(n_lat - 1, j)))
    faces = np.asarray(faces, np.int32)

    b = np.arcsin(np.clip(dirs[:, 1], -1, 1))       # elevation
    a = np.arctan2(dirs[:, 0], dirs[:, 2])          # azimuth from +z (front)
    return dirs.astype(np.float64), faces, (a, b)


def face_mesh(
    p: np.ndarray,
    expression: int = 0,
    n_lat: int = 64,
    n_lon: int = 96,
):
    """Build one (identity, expression) head mesh.

    Returns (verts [V,3] float64 world units, faces [F,3] int32,
    face_albedo [F,3] float32). Nose points toward +z (the frontal camera
    of pose_spherical(0, 0, r), ops/rays.py:104-119); y is up."""
    p = np.asarray(p, np.float64)
    assert p.shape == (N_ID_PARAMS,), p.shape
    e = EXPRESSION_PARAMS.get(int(expression), EXPRESSION_PARAMS[0])

    dirs, faces, (a, b) = _sphere_topology(n_lat, n_lon)
    f = _feature_fields(a, b, p, e)
    radius = _HEAD_RADIUS * (1.0 + f["bump"])
    scale = np.array([
        1.0 + 0.18 * p[0],
        1.06 + 0.20 * p[1] + 0.04 * e[0],   # jaw-open elongates the head
        1.0 + 0.15 * p[2],
    ])
    verts = dirs * radius[:, None] * scale[None, :]

    vert_albedo = _albedo_at(a, b, p, e)
    face_albedo = vert_albedo[faces].mean(axis=1).astype(np.float32)
    return verts, faces, face_albedo


def face_uv_map(p: np.ndarray, expression: int = 0, size: int = 512) -> np.ndarray:
    """Spherical-unwrap albedo texture [size, size, 3] float in [0,1] —
    the identity's UV map (the reference feeds textureMap300/{id}/
    1_neutral.jpg to the texture encoder, run_train.py:18-22). Content is
    the SAME albedo function that colors the rasterized GT, so the texture
    code genuinely predicts rendered appearance."""
    p = np.asarray(p, np.float64)
    e = EXPRESSION_PARAMS.get(int(expression), EXPRESSION_PARAMS[0])
    a = np.linspace(-np.pi, np.pi, size)
    b = np.linspace(np.pi / 2, -np.pi / 2, size)
    bb, aa = np.meshgrid(b, a, indexing="ij")
    return _albedo_at(aa, bb, p, e).astype(np.float32)


# 68-landmark layout: (azimuth, elevation) anchors in the standard
# jaw(17) / brows(10) / nose(9) / eyes(12) / mouth(20) order.
def _landmark_angles(p: np.ndarray, e) -> np.ndarray:
    e = _exp_vec(e)
    eye_sp = 0.42 * (1 + 0.25 * p[6])
    a_m = 0.30 * e[3]
    mouth_w = ((0.34 * (1 + 0.25 * p[7]) + 0.14 * e[1])
               * (1 - 0.45 * max(e[4], 0.0)) * (1 - 0.25 * e[5]))
    brow_b = 0.50 + 0.05 * e[2]
    pts = []
    # jawline: arc from left ear to right ear through the chin
    for t in np.linspace(-1.0, 1.0, 17):
        pts.append((1.2 * t, -0.55 - 0.40 * (1 - t * t)))
    for side in (-1, 1):  # brows: 5 each
        for t in np.linspace(-0.20, 0.20, 5):
            pts.append((side * eye_sp + t, brow_b))
    for t in np.linspace(0.10, -0.25, 4):  # nose bridge
        pts.append((0.0, t))
    for t in np.linspace(-0.28, 0.28, 5):  # nostril line
        pts.append((t * 0.8, -0.30))
    for side in (-1, 1):  # eyes: 6 each
        for k in range(6):
            ang = 2 * np.pi * k / 6
            pts.append((side * eye_sp + 0.13 * np.cos(ang), 0.30 + 0.07 * np.sin(ang)))
    for k in range(12):  # outer lip ellipse
        ang = 2 * np.pi * k / 12
        pts.append((a_m + mouth_w * np.cos(ang),
                    -0.50 + (0.10 + 0.08 * e[0]) * np.sin(ang)))
    for k in range(8):  # inner lip ellipse
        ang = 2 * np.pi * k / 8
        pts.append((a_m + 0.6 * mouth_w * np.cos(ang), -0.50 + 0.05 * np.sin(ang)))
    return np.asarray(pts, np.float64)  # [68, 2]


def face_landmarks(p: np.ndarray, expression: int = 0) -> np.ndarray:
    """[68, 3] world-space landmarks on the displaced surface."""
    p = np.asarray(p, np.float64)
    e = EXPRESSION_PARAMS.get(int(expression), EXPRESSION_PARAMS[0])
    ab = _landmark_angles(p, e)
    a, b = ab[:, 0], ab[:, 1]
    f = _feature_fields(a, b, p, e)
    radius = _HEAD_RADIUS * (1.0 + f["bump"])
    y = np.sin(b)
    x = np.cos(b) * np.sin(a)
    z = np.cos(b) * np.cos(a)
    dirs = np.stack([x, y, z], -1)
    scale = np.array([1.0 + 0.18 * p[0], 1.06 + 0.20 * p[1] + 0.04 * e[0],
                      1.0 + 0.15 * p[2]])
    return (dirs * radius[:, None] * scale[None, :]).astype(np.float32)


def make_face_dataset(
    out_dir: str,
    n_ids: int = 8,
    exp_ids: Sequence[int] = (0, 1, 2),
    res: int = 128,
    seed: int = 0,
    n_workers: int = 1,
    view_stride: int = 1,
    n_holdout: int = 20,
    n_lat: int = 64,
    n_lon: int = 96,
    id_params: "np.ndarray | None" = None,
    device="cuda",
) -> np.ndarray:
    """Produce a full FaceScape-format multiview dataset of the synthetic
    face family: per-id split JSONs + images (datagen/multiview.py), UV
    maps under uv/{id}/1_neutral.jpg, factors_id.npy shape codes,
    landmarks.npy [n, 20, 68, 3] (x50: the train loop divides by the world
    scale, run_train.py:121), and face_params.npy (the ground-truth
    identity parameters, for studies). Returns the [n_ids, N_ID_PARAMS]
    parameter matrix. Resumable per identity.

    `id_params` overrides the seeded identity sampling with an explicit
    [n, N_ID_PARAMS] matrix — the generator is linear in the params, so
    passing interpolated rows yields the TRUE intermediate faces (used to
    densify code space along interpolation paths). The frames are rasterized
    on `device`."""
    from mofanerf_tpu_torch.datagen.multiview import render_identities_parallel
    from mofanerf_tpu_torch.utils.device import resolve_device
    from mofanerf_tpu_torch.utils.image_io import write_jpeg

    device = str(resolve_device(device))
    os.makedirs(out_dir, exist_ok=True)
    if id_params is not None:
        params = np.asarray(id_params, np.float32)
        n_ids = len(params)
    else:
        params = sample_identity_params(n_ids, seed)

    # Resume guard: generation is resumable per identity, which means a
    # CONFIG change silently keeps stale identities (round 4's refine corpus
    # carried 8 defective identity-0 views exactly this way — see
    # artifacts/refine_nerf_quality.json round-4 vintage / VERDICT r4 weak
    # #3). Any mismatch with the recorded generation config is a hard error.
    meta = {"n_ids": int(n_ids), "exp_ids": list(map(int, exp_ids)),
            "res": int(res), "seed": int(seed),
            "view_stride": int(view_stride), "n_holdout": int(n_holdout),
            "n_lat": int(n_lat), "n_lon": int(n_lon),
            "explicit_id_params": id_params is not None}
    fam_path = os.path.join(out_dir, "family.json")
    if os.path.exists(fam_path):
        with open(fam_path) as fh:
            old = json.load(fh)
        if old != meta:
            diff = {k: (old.get(k), meta[k]) for k in meta
                    if old.get(k) != meta[k]}
            raise RuntimeError(
                f"{out_dir} was generated with a different config "
                f"(old vs new: {diff}); resuming would mix stale and fresh "
                f"identities — delete the directory to regenerate")
    else:
        with open(fam_path, "w") as fh:
            json.dump(meta, fh)

    loader = _FaceMeshLoader(params, tuple(exp_ids), n_lat, n_lon)
    render_identities_parallel(
        list(range(n_ids)), loader, out_dir, n_workers=n_workers,
        res=res, view_stride=view_stride, n_holdout=n_holdout, seed=seed, device=device,
    )

    uvdir = os.path.join(out_dir, "uv")
    for pid in range(n_ids):
        d = os.path.join(uvdir, str(pid))
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "1_neutral.jpg")
        if not os.path.exists(path):
            uv = face_uv_map(params[pid], 0, size=256)
            write_jpeg(path, (uv * 255).astype(np.uint8))

    n_rows = max(300, n_ids)  # reference layout: factors_id.npy is [300, 50]
    codes = np.zeros((n_rows, SHAPE_CODE_DIM), np.float32)
    codes[:n_ids] = shape_code_from_params(params)
    np.save(os.path.join(out_dir, "factors_id.npy"), codes)

    lms = np.zeros((n_rows, 20, 68, 3), np.float32)
    for pid in range(n_ids):
        for exp in range(20):
            lms[pid, exp] = face_landmarks(
                params[pid], exp if exp in EXPRESSION_PARAMS else 0)
    np.save(os.path.join(out_dir, "landmarks.npy"), lms * 50.0)

    np.save(os.path.join(out_dir, "face_params.npy"), params)
    return params


class _FaceMeshLoader:
    """Picklable mesh loader for the multiprocessing fan-out."""

    def __init__(self, params, exp_ids, n_lat, n_lon):
        self.params, self.exp_ids = params, exp_ids
        self.n_lat, self.n_lon = n_lat, n_lon

    def __call__(self, pid: int):
        return {
            exp: face_mesh(self.params[pid], exp, self.n_lat, self.n_lon)
            for exp in self.exp_ids
        }
