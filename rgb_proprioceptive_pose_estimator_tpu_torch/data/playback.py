"""A copy of the JAX package's ``data/playback.py`` (jax-free), for the
port's ``cli render``. Its isolated render child imports neither torch
nor a module that does (the package's ``__init__`` skips them under
``_RPPE_RENDER_WORKER``).

robosuite state-playback ingestion: render observations from demo
files that store only MuJoCo sim states.

The robosuite demonstration collector (`[RECALL]` SURVEY.md section 1.3;
robosuite gather_demonstrations_as_hdf5) writes demos WITHOUT rendered
observations: `data/demo_N/states` is the flattened MuJoCo sim state per
step ([time, qpos, qvel] — the mujoco-py MjSimState layout) and the MJCF
model XML rides along as the `model_file` attribute. The reference
re-renders observations by playing those states back through robosuite.

This module is the TPU-native equivalent built on plain `mujoco`
offscreen rendering (EGL, software mesa works headless — no robosuite
needed, PROVIDED the MJCF is self-contained or its referenced assets
exist on disk): it replays every state, renders the requested cameras,
extracts the target body's world pose, and MATERIALIZES a standard
robomimic-layout HDF5 (`obs/<cam>_image`, `obs/qpos`, `obs/qvel`,
`obs/object`) that the existing `HDF5DemoStore` pipeline — splits,
caching, device_cache, everything — consumes unchanged. One-time
conversion rather than render-in-the-hot-loop: GL rendering is
~ms/frame, which belongs in a preprocessing pass, not in a 20k img/s
input pipeline (same philosophy as the decode-once resize cache).

Proprio note: robosuite's `robot0_proprio-state` is computed by env code
this environment does not have; the faithful raw equivalent is the
joint state itself. `obs/qpos`/`obs/qvel` EXCLUDE the dofs of the target
body's own joints (a free-floating target's pose would otherwise leak
the label into proprio — the r1 fixture bug, relearned for real data);
consume them with `data.proprio_key="obs/qpos,obs/qvel"`.

Layout handled per demo group:
  states: (T, 1 + nq + nv [+ na...]) robosuite/mujoco-py flatten (time
          column), or (T, nq + nv) raw concatenation — detected by width.
  model_file attr on the demo group, on `data`, or passed explicitly.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _import_mujoco():
    # EGL before first import: headless GL on this stack needs both knobs
    # (MUJOCO_GL picks mujoco's context class, PYOPENGL_PLATFORM keeps
    # PyOpenGL off GLX, which needs an X display)
    os.environ.setdefault("MUJOCO_GL", "egl")
    os.environ.setdefault("PYOPENGL_PLATFORM", "egl")
    import mujoco

    return mujoco


def missing_render_modules() -> List[str]:
    """The modules a render needs that this host lacks: ``mujoco`` for
    the scene and ``h5py`` for the states and rendered files."""
    missing = []
    for name, load in (("mujoco", _import_mujoco),
                       ("h5py", lambda: __import__("h5py"))):
        try:
            load()
        except ImportError:
            missing.append(name)
    return missing


def split_state(state: np.ndarray, nq: int, nv: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Split one flattened sim state into (qpos, qvel).

    Width exactly nq+nv parses as the raw [qpos, qvel] concatenation;
    any width >= 1+nq+nv parses as the mujoco-py MjSimState flatten
    [time, qpos, qvel, act, udd...] (the robosuite collector's format,
    and the only known producer that appends extra fields -- a
    hypothetical raw [qpos, qvel, extras] layout is indistinguishable
    by width and would be parsed as time-prefixed). Anything narrower
    is a loud error."""
    w = state.shape[-1]
    if w == nq + nv:
        return state[:nq], state[nq:nq + nv]
    if w >= 1 + nq + nv:
        return state[1:1 + nq], state[1 + nq:1 + nq + nv]
    raise ValueError(
        f"state width {w} matches neither [time,qpos,qvel,...] "
        f"(>= {1 + nq + nv}) nor [qpos,qvel] ({nq + nv}) for a model "
        f"with nq={nq}, nv={nv}")


def _target_dof_mask(mujoco, model, bid: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Boolean keep-masks over (qpos, qvel) excluding every joint that
    belongs to body `bid` or its descendants (their state IS the
    label)."""
    # descendants: body_parentid chains upward
    target_bodies = {bid}
    for b in range(model.nbody):
        p = b
        while p > 0:
            p = int(model.body_parentid[p])
            if p in target_bodies:
                target_bodies.add(b)
                break
    qpos_keep = np.ones(model.nq, bool)
    qvel_keep = np.ones(model.nv, bool)
    sizes_q = {0: 7, 1: 4, 2: 1, 3: 1}   # free, ball, slide, hinge
    sizes_v = {0: 6, 1: 3, 2: 1, 3: 1}
    for j in range(model.njnt):
        if int(model.jnt_bodyid[j]) in target_bodies:
            qa, va = int(model.jnt_qposadr[j]), int(model.jnt_dofadr[j])
            t = int(model.jnt_type[j])
            qpos_keep[qa:qa + sizes_q[t]] = False
            qvel_keep[va:va + sizes_v[t]] = False
    return qpos_keep, qvel_keep


def _resolve_target(mujoco, model, target_body: str, target_site: str
                    ) -> Tuple[int, int]:
    """Resolve the pose target: returns (site_id or -1, body id). A site
    (e.g. an end-effector grip site -- SURVEY.md section 1.3: the
    reference estimates "an object or end-effector pose") reads its pose
    from site_xpos/site_xmat and excludes the dofs of its parent body;
    a body reads xpos/xquat."""
    if target_site:
        sid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_SITE,
                                target_site)
        if sid < 0:
            names = [mujoco.mj_id2name(model, mujoco.mjtObj.mjOBJ_SITE, i)
                     for i in range(model.nsite)]
            raise ValueError(f"target site {target_site!r} not in model "
                             f"(sites: {names})")
        bid = int(model.site_bodyid[sid])
        if bid == 0:
            raise ValueError(
                f"target site {target_site!r} is attached to the "
                "worldbody: its pose is constant -- not a learnable "
                "estimation target (and excluding 'world descendants' "
                "would strip every dof from proprio)")
        return sid, bid
    bid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_BODY, target_body)
    if bid < 0:
        names = [mujoco.mj_id2name(model, mujoco.mjtObj.mjOBJ_BODY, i)
                 for i in range(model.nbody)]
        raise ValueError(f"target body {target_body!r} not in model "
                         f"(bodies: {names})")
    if bid == 0:
        raise ValueError("target body is the worldbody: its pose is "
                         "constant -- not a learnable estimation target")
    return -1, bid


def render_playback_dataset(
    src_path: str,
    out_path: str,
    cameras: Sequence[str] = ("agentview",),
    image_hw: int = 128,
    target_body: str = "cube",
    model_xml: Optional[str] = None,
    max_demos: int = 0,
    target_site: str = "",
    encoding: str = "raw",
    isolate: bool = True,
) -> Dict[str, int]:
    """Replay `states` demos from `src_path` and write a rendered
    robomimic-layout HDF5 to `out_path`. Returns a summary dict.

    encoding: "raw" stores (T,H,W,3) uint8 (gzip level 1); "jpeg"/"png"
    store per-frame encoded bytes in (T,) vlen-uint8 datasets (the
    robomimic-in-the-wild layout HDF5DemoStore already decodes) --
    ~10x smaller files for 224px collections at JPEG's usual cost.

    isolate=True (default) runs the GL work in a CHILD python process:
    software-mesa EGL (llvmpipe) embeds its own LLVM, and hosting it in
    the same process as XLA:CPU's LLVM was observed to abort later,
    unrelated XLA compilations on this stack (intermittent SIGABRT mid-
    fit once enough GL state accumulated). The converter is a batch
    preprocessing step; one ~1 s process spawn buys a training process
    that never loads GL. isolate=False renders in-process.

    model_xml overrides the files' `model_file` attrs (for demo files
    that reference an external model). Renderers (and the target-dof
    masks) are cached per distinct model XML, so multi-model files pay
    one compile per model, not per demo. On any error the partial
    output file is removed -- a truncated dataset must never look like
    a finished one (downstream callers cache on file existence)."""
    if isolate and not os.environ.get("_RPPE_RENDER_WORKER"):
        return _render_in_subprocess(
            src_path=src_path, out_path=out_path, cameras=list(cameras),
            image_hw=image_hw, target_body=target_body,
            model_xml=model_xml, max_demos=max_demos,
            target_site=target_site, encoding=encoding)

    import h5py

    from rgb_proprioceptive_pose_estimator_tpu_torch.data import augment as aug
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
        _natural_key,
    )

    if encoding not in ("raw", "jpeg", "png"):
        raise ValueError(
            f"encoding must be raw/jpeg/png, got {encoding!r}")
    if encoding != "raw":
        # probe encode up front: discovering a missing opencv AFTER the
        # first demo rendered (~minutes) would waste all that GL work
        try:
            aug.encode_image(np.zeros((2, 2, 3), np.uint8),
                             ".jpg" if encoding == "jpeg" else ".png")
        except RuntimeError as e:
            raise ValueError(f"--encode {encoding} needs opencv: {e}")

    mujoco = _import_mujoco()

    # xml digest -> (model, data, rend, qpos_keep, qvel_keep, sid, bid)
    renderers: Dict[str, tuple] = {}

    def ctx_for(xml: str):
        key = hashlib.sha1(xml.encode()).hexdigest()
        if key not in renderers:
            model = mujoco.MjModel.from_xml_string(xml)
            # validate BEFORE constructing the Renderer: a failed ctx
            # must not leak an EGL context
            for cam in cameras:
                if mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_CAMERA,
                                     cam) < 0:
                    have = [mujoco.mj_id2name(
                        model, mujoco.mjtObj.mjOBJ_CAMERA, i)
                        for i in range(model.ncam)]
                    raise ValueError(
                        f"camera {cam!r} not in model (cameras: {have})")
            sid, bid = _resolve_target(mujoco, model, target_body,
                                       target_site)
            qpos_keep, qvel_keep = _target_dof_mask(mujoco, model, bid)
            data = mujoco.MjData(model)
            rend = mujoco.Renderer(model, image_hw, image_hw)
            renderers[key] = (model, data, rend, qpos_keep, qvel_keep,
                              sid, bid)
        return renderers[key]

    n_demos = n_frames = 0
    tmp_path = out_path + ".tmp"
    try:
      with h5py.File(src_path, "r") as src, h5py.File(tmp_path, "w") as out:
        if "data" not in src:
            raise ValueError(f"{src_path}: no 'data' group "
                             "(not a robosuite-layout demo file)")
        sdata = src["data"]
        odata = out.create_group("data")
        for a, v in sdata.attrs.items():
            odata.attrs[a] = v
        odata.attrs["rendered_by"] = "rppe_tpu_playback_v1"

        # natural order (demo_2 before demo_10), matching HDF5DemoStore's
        # enumeration so max_demos means "the first N demos"
        demo_names = sorted(sdata.keys(), key=_natural_key)
        if max_demos:
            demo_names = demo_names[:max_demos]
        for dk in demo_names:
            g = sdata[dk]
            if "states" not in g:
                raise ValueError(f"{src_path}:{dk} has no 'states' "
                                 "dataset (not a state-playback demo)")
            xml = model_xml or g.attrs.get(
                "model_file", sdata.attrs.get("model_file", ""))
            if not xml:
                raise ValueError(
                    f"{src_path}:{dk}: no model_file attribute on the "
                    "demo or data group; pass model_xml=")
            if isinstance(xml, bytes):
                xml = xml.decode()
            model, mjd, rend, qpos_keep, qvel_keep, sid, bid = ctx_for(xml)

            states = np.asarray(g["states"])
            T = states.shape[0]
            imgs = {c: np.empty((T, image_hw, image_hw, 3), np.uint8)
                    for c in cameras}
            qpos_out = np.empty((T, int(qpos_keep.sum())), np.float32)
            qvel_out = np.empty((T, int(qvel_keep.sum())), np.float32)
            obj = np.empty((T, 7), np.float32)
            for t in range(T):
                qp, qv = split_state(states[t], model.nq, model.nv)
                mjd.qpos[:] = qp
                mjd.qvel[:] = qv
                mujoco.mj_forward(model, mjd)
                for c in cameras:
                    rend.update_scene(mjd, camera=c)
                    imgs[c][t] = rend.render()
                qpos_out[t] = qp[qpos_keep]
                qvel_out[t] = qv[qvel_keep]
                if sid >= 0:                   # site target (e.g. eef)
                    obj[t, :3] = mjd.site_xpos[sid]
                    q = np.empty(4)
                    mujoco.mju_mat2Quat(q, mjd.site_xmat[sid])
                    obj[t, 3:] = q             # (w, x, y, z)
                else:                          # body target (e.g. object)
                    obj[t, :3] = mjd.xpos[bid]
                    obj[t, 3:] = mjd.xquat[bid]

            og = odata.create_group(dk)
            og.attrs["num_samples"] = T
            obs = og.create_group("obs")
            for c in cameras:
                if encoding == "raw":
                    obs.create_dataset(f"{c}_image", data=imgs[c],
                                       compression="gzip",
                                       compression_opts=1)
                else:
                    ext = ".jpg" if encoding == "jpeg" else ".png"
                    ds = obs.create_dataset(
                        f"{c}_image", (T,),
                        dtype=h5py.vlen_dtype(np.uint8))
                    ds[...] = [aug.encode_image(imgs[c][t], ext)
                               for t in range(T)]
            obs["qpos"] = qpos_out
            obs["qvel"] = qvel_out
            obs["object"] = obj
            n_demos += 1
            n_frames += T

        # copy robomimic filter masks through so data.filter_key works
        if "mask" in src:
            src.copy("mask", out)
      # success: the finished file appears atomically under its real name
      os.replace(tmp_path, out_path)
    except BaseException:
        # a truncated output must never look like a finished dataset
        # (downstream callers cache on file existence)
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        raise
    finally:
        for model, mjd, rend, *_ in renderers.values():
            rend.close()
    return {"demos": n_demos, "frames": n_frames,
            "cameras": len(cameras), "image_hw": image_hw}


# ---------------------------------------------------------------------------
# Self-contained states fixture (tests / demos without robosuite assets)

_FIXTURE_XML = """
<mujoco model="lift_states_fixture">
  <option gravity="0 0 0"/>
  <worldbody>
    <light pos="0 0 3" dir="0 0 -1"/>
    <geom name="floor" type="plane" size="2 2 .1" rgba=".3 .3 .3 1"/>
    <body name="arm" pos="0 0 0.3">
      <joint name="arm_x" type="slide" axis="1 0 0"/>
      <joint name="arm_y" type="slide" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 0 0 .2" size=".04" rgba=".2 .4 1 1"/>
      <site name="grip" pos="0 0 .22" size=".005"/>
    </body>
    <body name="cube" pos="0 0 0.5">
      <freejoint name="cube_joint"/>
      <geom type="box" size=".06 .06 .06" rgba="1 .2 .1 1"/>
      <!-- distinct face plates: a uniformly-colored cube is visually
           rotation-symmetric (orientation unlearnable from pixels --
           measured: 49 deg rot MAE, i.e. chance); marked +x/+y/+z faces
           make the rendered orientation observable -->
      <geom type="box" pos=".06 0 0" size=".004 .035 .035" rgba="0 1 0 1"/>
      <geom type="box" pos="0 .06 0" size=".035 .004 .035" rgba="0 .3 1 1"/>
      <geom type="box" pos="0 0 .06" size=".035 .035 .004" rgba="1 1 0 1"/>
    </body>
    <camera name="agentview" pos="1.2 0 0.8" xyaxes="0 1 0 -0.5 0 1"/>
    <camera name="sideview" pos="0 1.2 0.8" xyaxes="-1 0 0 0 -0.5 1"/>
  </worldbody>
</mujoco>
"""


def write_states_fixture(path: str, n_demos: int = 2, steps: int = 12,
                         seed: int = 0) -> str:
    """Write a tiny self-contained state-playback demo file in the
    robosuite layout (states + model_file attr, NO rendered obs): a
    free-floating cube (the target) plus a 2-dof 'arm' whose joints are
    the legitimate proprio. Smooth random-walk states, [time, qpos,
    qvel] flattening (the mujoco-py MjSimState convention)."""
    import h5py

    rs = np.random.RandomState(seed)
    nq, nv = 9, 8                      # 2 slides + free joint (7, 6)
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        data.attrs["env"] = "Lift_states_fixture"
        data.attrs["model_file"] = _FIXTURE_XML
        for d in range(n_demos):
            g = data.create_group(f"demo_{d}")
            states = np.zeros((steps, 1 + nq + nv), np.float64)
            arm = rs.uniform(-0.3, 0.3, 2)
            pos = rs.uniform(-0.25, 0.25, 3) + [0, 0, 0.5]
            quat = np.array([1.0, 0, 0, 0])
            for t in range(steps):
                arm = arm + rs.randn(2) * 0.02
                pos = pos + rs.randn(3) * 0.015
                quat = quat + rs.randn(4) * 0.05
                quat = quat / np.linalg.norm(quat)
                states[t, 0] = t * 0.05                  # time column
                states[t, 1:3] = arm                     # arm qpos
                states[t, 3:6] = pos                     # cube pos
                states[t, 6:10] = quat                   # cube quat
                states[t, 10:] = rs.randn(nv) * 0.01     # qvel filler
            g["states"] = states
    return path


# ---------------------------------------------------------------------------
# Flagship-shape states fixture (VERDICT r3 next-4): dual-camera
# (fixed agentview + wrist-mounted robot0_eye_in_hand -- the pr5 preset's
# camera pair), 4-dof arm with a grip site, free cube target, and a
# physical occluder wall that blinds the agentview on roughly the y<0
# half of the workspace while the wrist camera (which tracks the cube
# from the arm side) still sees it. Rendered demos from this scene need
# the full pr5 feature set: dual-camera fusion (per-camera occlusion is
# PHYSICAL here, line-of-sight through a wall), temporal stacking (the
# cube moves with constant per-episode velocity, so future-pose labels
# are single-frame-ambiguous), camera_dropout (dead-sensor serving), and
# correlated mixed-unit proprio (the arm servos toward the cube, so its
# joint state carries lagged target information in radians vs the label's
# meters).

FLAGSHIP_XML = """
<mujoco model="flagship_fixture">
  <option gravity="0 0 0"/>
  <visual><headlight ambient=".45 .45 .45" diffuse=".55 .55 .55"/></visual>
  <asset>
    <texture type="skybox" builtin="gradient" rgb1=".35 .45 .55" rgb2=".1 .1 .15" width="128" height="128"/>
    <texture name="grid" type="2d" builtin="checker" rgb1=".3 .3 .35" rgb2=".45 .45 .5" width="256" height="256"/>
    <material name="grid" texture="grid" texrepeat="10 10"/>
  </asset>
  <worldbody>
    <light pos="0 0 3" dir="0 0 -1"/>
    <light pos="1.5 1 2.5" dir="-0.5 -0.3 -1"/>
    <geom name="floor" type="plane" size="2.5 2.5 .1" material="grid"/>
    <body name="focus" pos="-0.05 0 0.5"/>
    <geom name="occluder" type="box" pos="0.62 -0.105 0.46" size=".02 .19 .46" rgba=".55 .45 .35 1"/>
    <body name="base" pos="-0.55 0 0.15">
      <geom type="cylinder" size=".07 .15" rgba=".2 .2 .25 1"/>
      <body name="link1" pos="0 0 .15">
        <joint name="j1" type="hinge" axis="0 0 1" range="-3 3"/>
        <geom type="capsule" fromto="0 0 0 .3 0 .1" size=".035" rgba=".2 .4 1 1"/>
        <body name="link2" pos=".3 0 .1">
          <joint name="j2" type="hinge" axis="0 1 0" range="-2 2"/>
          <geom type="capsule" fromto="0 0 0 .28 0 0" size=".03" rgba=".25 .5 .9 1"/>
          <body name="link3" pos=".28 0 0">
            <joint name="j3" type="hinge" axis="0 1 0" range="-2 2"/>
            <geom type="capsule" fromto="0 0 0 .22 0 0" size=".025" rgba=".3 .6 .85 1"/>
            <body name="wrist" pos=".22 0 0">
              <joint name="j4" type="hinge" axis="1 0 0" range="-3 3"/>
              <geom type="box" size=".035 .025 .02" rgba=".85 .8 .2 1"/>
              <site name="grip" pos=".05 0 0" size=".008" rgba="1 0 0 1"/>
              <camera name="robot0_eye_in_hand" pos="0 0 .09" zaxis="-1 0 0.45"/>
            </body>
          </body>
        </body>
      </body>
    </body>
    <body name="cube" pos="0.25 0 0.55">
      <freejoint name="cube_joint"/>
      <geom type="box" size=".075 .075 .075" rgba="1 .25 .1 1"/>
      <!-- all SIX faces uniquely marked: any visible face triple fully
           determines orientation (3 marked faces leave a whole SO(3)
           region plate-free and measured rotation at chance) -->
      <geom type="box" pos=".075 0 0" size=".005 .048 .048" rgba="0 1 0 1"/>
      <geom type="box" pos="-.075 0 0" size=".005 .048 .048" rgba="1 0 1 1"/>
      <geom type="box" pos="0 .075 0" size=".048 .005 .048" rgba="0 .3 1 1"/>
      <geom type="box" pos="0 -.075 0" size=".048 .005 .048" rgba="0 1 1 1"/>
      <geom type="box" pos="0 0 .075" size=".048 .048 .005" rgba="1 1 0 1"/>
      <geom type="box" pos="0 0 -.075" size=".048 .048 .005" rgba="1 1 1 1"/>
    </body>
    <camera name="agentview" mode="targetbody" target="focus" pos="1.30 0.20 0.85" fovy="32"/>
  </worldbody>
</mujoco>
"""

# workspace the cube bounces in (visible to the aimed agentview; spans
# both sides of the occluder's shadow so ~half the steps are occluded)
_WS_LO = np.array([-0.30, -0.35, 0.35])
_WS_HI = np.array([0.40, 0.35, 0.70])
_JNT_LO = np.array([-3.0, -2.0, -2.0, -3.0])
_JNT_HI = np.array([3.0, 2.0, 2.0, 3.0])


def write_flagship_states_fixture(path: str, n_demos: int = 8,
                                  steps: int = 40, seed: int = 0,
                                  cube_speed: float = 0.030,
                                  cube_spin: float = 0.35,
                                  servo_iters: int = 25,
                                  standoff: float = 0.32) -> str:
    """Write a flagship-shape state-playback demo file (robosuite layout:
    `states` + `model_file` attr, no rendered obs; render with
    render_playback_dataset / `cli render`).

    Per episode: the cube gets a constant linear velocity (magnitude
    `cube_speed` per step, reflecting off the workspace box) and a
    constant body-frame angular velocity (`cube_spin` rad/step scale) --
    SINGLE-frame pixels cannot reveal velocity, so labels derived from
    future poses need temporal context. The arm runs a candidate-descent
    servo toward a `standoff` hover with the wrist camera pointed at the
    cube, warm-started per step with only `servo_iters` proposals --
    realistic lagged tracking, so the wrist view usually (not always)
    contains the target. Needs mujoco for kinematics (no GL)."""
    import h5py

    mujoco = _import_mujoco()
    model = mujoco.MjModel.from_xml_string(FLAGSHIP_XML)
    data = mujoco.MjData(model)
    gid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_SITE, "grip")
    cid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_CAMERA,
                            "robot0_eye_in_hand")
    nq, nv = model.nq, model.nv          # 11, 10 (4 hinges + free joint)
    rs = np.random.RandomState(seed)

    def servo_cost(q: np.ndarray, cube: np.ndarray) -> float:
        data.qpos[:4] = q
        data.qpos[4:7] = cube
        mujoco.mj_forward(model, data)
        d = float(np.linalg.norm(data.site_xpos[gid] - cube))
        fwd = -data.cam_xmat[cid].reshape(3, 3)[:, 2]
        to_cube = cube - data.cam_xpos[cid]
        to_cube = to_cube / (np.linalg.norm(to_cube) + 1e-9)
        # pointing dominates: a cube outside the wrist camera's ~45 deg
        # fov is useless however good the standoff is
        return abs(d - standoff) + 1.2 * (1.0 - float(fwd @ to_cube))

    def servo(q: np.ndarray, cube: np.ndarray, iters: int,
              restarts: int = 0) -> np.ndarray:
        best, c0 = q.copy(), servo_cost(q, cube)
        starts = [q] + [rs.uniform(_JNT_LO, _JNT_HI)
                        for _ in range(restarts)]
        for start in starts:
            cur, cc0 = start.copy(), servo_cost(start, cube)
            for it in range(iters):
                step = 0.3 if it < iters // 2 else 0.1
                cand = np.clip(cur + rs.randn(4) * step, _JNT_LO, _JNT_HI)
                cc = servo_cost(cand, cube)
                if cc < cc0:
                    cur, cc0 = cand, cc
            if cc0 < c0:
                best, c0 = cur, cc0
        return best

    with h5py.File(path, "w") as f:
        fdata = f.create_group("data")
        fdata.attrs["env"] = "flagship_states_fixture"
        fdata.attrs["model_file"] = FLAGSHIP_XML
        for d in range(n_demos):
            pos = rs.uniform(_WS_LO, _WS_HI)
            vel = rs.randn(3)
            vel = vel / np.linalg.norm(vel) * cube_speed
            omega = rs.randn(3) * cube_spin          # rad/step, body frame
            quat = rs.randn(4)
            quat = quat / np.linalg.norm(quat)
            q = servo(rs.uniform(-0.5, 0.5, 4), pos, iters=120, restarts=3)
            prev_q = q.copy()
            states = np.zeros((steps, 1 + nq + nv), np.float64)
            for t in range(steps):
                states[t, 0] = t * 0.05
                states[t, 1:5] = q
                states[t, 5:8] = pos
                states[t, 8:12] = quat
                # qvel: arm joint rates (finite difference), cube linear
                # velocity (per-second: /dt), body-frame angular rate
                states[t, 1 + nq:1 + nq + 4] = (q - prev_q) / 0.05
                states[t, 1 + nq + 4:1 + nq + 7] = vel / 0.05
                states[t, 1 + nq + 7:1 + nq + 10] = omega / 0.05
                # advance: bounce the cube, integrate the spin, re-servo
                prev_q = q.copy()
                pos = pos + vel
                for ax in range(3):
                    if pos[ax] < _WS_LO[ax] or pos[ax] > _WS_HI[ax]:
                        vel[ax] = -vel[ax]
                        pos[ax] = np.clip(pos[ax], _WS_LO[ax], _WS_HI[ax])
                qn = quat.copy()
                mujoco.mju_quatIntegrate(qn, omega, 1.0)
                quat = qn / np.linalg.norm(qn)
                q = servo(q, pos, iters=servo_iters)
            g = fdata.create_group(f"demo_{d}")
            g["states"] = states
    return path


def _render_in_subprocess(**kw) -> Dict[str, int]:
    """Run render_playback_dataset in a child interpreter (see the
    isolate= doc). The child reads kwargs as JSON on stdin and prints the
    summary as the last stdout line. Exceptions relay as a typed JSON
    record (builtin exception types re-raise as themselves with the full,
    possibly multi-line message) so callers' error handling is
    process-location-agnostic. _RPPE_RENDER_WORKER=1 makes the package
    __init__ skip its jax imports in the child: the GL process must not
    co-host XLA's LLVM with software-mesa's, and skipping them also cuts
    the per-child startup to roughly interpreter+mujoco time."""
    import builtins
    import json
    import subprocess
    import sys

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    extra = env.get("PYTHONPATH")
    # no trailing separator when PYTHONPATH is unset: an empty entry means
    # cwd to CPython, which could shadow real modules in the child
    env["PYTHONPATH"] = pkg_root + (os.pathsep + extra if extra else "")
    env["_RPPE_RENDER_WORKER"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m",
         "rgb_proprioceptive_pose_estimator_tpu_torch.data.playback"],
        input=json.dumps(kw), capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        err = None
        try:
            err = json.loads(
                proc.stdout.strip().splitlines()[-1]).get("_error")
        except Exception:
            pass   # no structured record (hard crash): stderr tail below
        if err:
            etype = getattr(builtins, str(err.get("type")), None)
            if isinstance(etype, type) and issubclass(etype, Exception):
                raise etype(err.get("message", ""))
            raise RuntimeError(f"{err.get('type')}: {err.get('message')}")
        raise RuntimeError(
            "playback render subprocess failed "
            f"(exit {proc.returncode}):\n{proc.stderr.strip()[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    import json as _json
    import sys as _sys

    _kw = _json.loads(_sys.stdin.read())
    _kw["cameras"] = tuple(_kw["cameras"])
    try:
        _res = render_playback_dataset(isolate=False, **_kw)
    except Exception as _e:
        # typed relay to the parent (last stdout line; see
        # _render_in_subprocess) -- stderr keeps the full traceback
        import traceback as _tb

        _tb.print_exc()
        print(_json.dumps({"_error": {"type": type(_e).__name__,
                                      "message": str(_e)}}))
        _sys.exit(3)
    print(_json.dumps(_res))
