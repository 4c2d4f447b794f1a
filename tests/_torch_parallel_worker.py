"""Worker of tests/test_torch_parallel.py: one rank of a gloo world on the
CPU running the port's parallel layer (rpg_svo_tpu_torch.parallel) on the
inputs the test wrote, then writing this rank's results.

argv: <coordinator host:port> <world size> <rank> <inputs.pkl> <out dir>

The world is laid out as hosts of 2 ranks (init_multihost's
local_device_count).  Tasks, in order (each rank runs every one): the
sharded seed update (sp = 4), sharded pose optimization (dp = 2, sp =
2), distributed BA at P and 2P points (sp = 4), vo_scan_mesh on (dp = 2,
sp = 2) and (dp = 1, sp = 4) and its df_update_k check, multistream_scan
with one stream per rank (global_mesh with inner size 1, host-local
rows), and multihost_ba_solve over (dp, sp) = (2, 2) from host-local
rows.  Every collective call of torch.distributed is counted.  Imports
the port only; prints WORKER_OK at the end.
"""

import os
import pickle
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

RAW = []   # every torch.distributed collective call: (name, bytes)


def _count_collectives():
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "broadcast", "reduce_scatter", "reduce_scatter_tensor",
                 "all_to_all", "all_to_all_single", "reduce", "gather",
                 "scatter", "send", "recv"):
        fn = getattr(dist, name)

        def wrap(*a, _fn=fn, _name=name, **kw):
            t = a[1] if _name == "all_gather" else a[0]
            RAW.append((_name, t.numel() * t.element_size()
                        if isinstance(t, torch.Tensor) else 0))
            return _fn(*a, **kw)
        setattr(dist, name, wrap)


def main():
    coord, world, rank, inp, out_dir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4], sys.argv[5]
    from rpg_svo_tpu_torch import config as tconfig
    from rpg_svo_tpu_torch.ba.schur import BAProblem
    from rpg_svo_tpu_torch.core import fused
    from rpg_svo_tpu_torch.core.convert import state_from_numpy
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    from rpg_svo_tpu_torch.parallel import gspmd, multihost, sharded
    from rpg_svo_tpu_torch.parallel.ba import distributed_ba_solve
    from rpg_svo_tpu_torch.parallel.fused_mesh import vo_scan_mesh
    from rpg_svo_tpu_torch.parallel.streams import (
        multistream_scan, stack_states)
    from rpg_svo_tpu_torch.utils.synthetic import reference_test_camera

    with open(inp, "rb") as f:
        data = pickle.load(f)
    dev = multihost.init_multihost(coord, world, rank, local_device_count=2,
                                   device="cpu")
    _count_collectives()
    res = {"rank": rank, "device": str(dev)}
    T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731

    def counted(fn):
        """(fn(), raw collective calls, logged collectives) of one call."""
        r0 = len(RAW)
        with gspmd.record_collectives() as log:
            out = fn()
        return out, RAW[r0:], log

    # --- the sharded seed update, sp = 4 --------------------------------
    mesh = sharded.make_mesh(world, dp=1, device="cpu")
    sd = data["seed"]
    args = sharded.shard_on(mesh, tuple(T(sd[k]) for k in (
        "mu", "sigma2", "a", "b", "z_range", "x", "tau2", "active")))
    out, raw, log = counted(lambda: sharded.sharded_seed_update(mesh, *args))
    full = gspmd.gather_dim0(tuple(out[:4]), "sp", mesh)
    res["seed"] = {"fields": [x.numpy() for x in full],
                   "n_conv": int(out[4]), "raw": raw, "log": log}

    # --- sharded pose optimization, dp = 2, sp = 2 ----------------------
    mesh22 = sharded.make_mesh(world, dp=2, device="cpu")
    pd = data["pose"]
    loc = sharded.shard_on(mesh22, (T(pd["p_w"]), T(pd["f"]),
                                    T(pd["level"]), T(pd["valid"])), "sp")
    T0 = SE3(torch.eye(3), torch.zeros(3))
    Tp, raw, log = counted(lambda: sharded.sharded_pose_optimize(
        mesh22, T0, *loc, n_iter=10))
    res["pose"] = {"R": Tp.R.numpy(), "t": Tp.t.numpy(), "raw": raw,
                   "log": log, "rows": int(loc[0].shape[0])}

    # --- distributed BA, sp = 4, at P and 2P points ---------------------
    res["ba"] = {}
    for P, pb in data["ba"].items():
        prob = BAProblem(*[T(pb[k]) for k in BAProblem._fields])
        local = prob._replace(**dict(zip(
            ("p_w", "p_valid", "obs_cam", "obs_f", "obs_level", "obs_mask"),
            sharded.shard_on(mesh, tuple(getattr(prob, k) for k in (
                "p_w", "p_valid", "obs_cam", "obs_f", "obs_level",
                "obs_mask")), "sp"))))
        (R, t, p, chi2), raw, log = counted(lambda: distributed_ba_solve(
            mesh, local, n_iter=data["ba_iters"], huber_width=0.01))
        res["ba"][P] = {"R": R.numpy(), "t": t.numpy(),
                        "p": gspmd.gather_dim0(p, "sp", mesh).numpy(),
                        "chi2": float(chi2), "raw": raw, "log": log}

    # --- vo_scan_mesh ---------------------------------------------------
    sc = data["scan"]
    cam = reference_test_camera(sc["shape"][1], sc["shape"][0])
    res["scan"] = {}
    for preset, dp in (("fast", 2), ("fast", 1), ("accurate", 2)):
        m = sharded.make_mesh(world, dp=dp, device="cpu")
        cfg = getattr(tconfig, f"{preset}_preset")(**sc["cfg_kw"])
        state = state_from_numpy(sc[preset]["state"], device="cpu")
        imgs = T(sc[preset]["imgs"])
        steps = []
        for img in imgs:
            (state, o), raw, log = counted(lambda: vo_scan_mesh(
                m, state, img[None], cam, cfg, sc["ncx"], sc["ncy"],
                tuple(sc["shape"])))
            o = fused.StepOut(*(x[0] for x in o))
            steps.append({"t_wc": o.t_wc.numpy(), "R_fw": o.R_fw.numpy(),
                          "is_keyframe": bool(o.is_keyframe),
                          "failed": bool(o.failed),
                          "n_matches": int(o.n_matches), "raw": raw,
                          "log": log})
        res["scan"][(preset, world // dp)] = steps
    try:   # sp = 4
        vo_scan_mesh(mesh, state, imgs[:1], cam, cfg.replace(df_update_k=90),
                     sc["ncx"], sc["ncy"], tuple(sc["shape"]))
        res["scan_k90"] = "no error"
    except ValueError as e:
        res["scan_k90"] = f"ValueError: {e}"

    # --- multistream_scan: one stream per rank, 2 hosts x 2 -------------
    st = data["streams"]
    gm = multihost.global_mesh("dp", "sp", inner_size=1)
    host = rank // 2
    mine = [2 * host, 2 * host + 1]
    host_states = stack_states([state_from_numpy(st["states"][s],
                                                 device="cpu")
                                for s in mine])
    import torch.utils._pytree as pytree
    local_states = pytree.tree_map(
        lambda x: multihost.host_local_rows(gm, x, ("dp",)), host_states)
    local_imgs = multihost.host_local_rows(
        gm, T(np.stack([st["imgs"][s] for s in mine])), ("dp",))
    cfg = tconfig.fast_preset(**sc["cfg_kw"])
    (_, outs), raw, log = counted(lambda: multistream_scan(
        gm, local_states, local_imgs, cam, cfg, sc["ncx"], sc["ncy"],
        tuple(sc["shape"])))
    res["streams"] = {"stream": rank, "t_wc": outs.t_wc.numpy(),
                      "failed": outs.failed.numpy(), "raw": raw,
                      "log": log, "mesh": tuple(gm.mesh.shape)}

    # --- multihost BA over (dp, sp) from host-local rows -----------------
    gm2 = multihost.global_mesh()
    pb = data["mh_ba"]
    P = pb["p_w"].shape[0]
    rows = slice(host * P // 2, (host + 1) * P // 2)
    pts = {k: multihost.host_local_rows(gm2, T(pb[k])[rows], ("dp", "sp"))
           for k in ("p_w", "p_valid", "obs_cam", "obs_f", "obs_level",
                     "obs_mask")}
    prob = BAProblem(R=multihost.replicated(gm2, T(pb["R"])),
                     t=multihost.replicated(gm2, T(pb["t"])),
                     cam_variable=multihost.replicated(
                         gm2, T(pb["cam_variable"])), **pts)
    (R, t, p, chi2), raw, log = counted(lambda: multihost.multihost_ba_solve(
        gm2, prob, n_iter=data["ba_iters"], huber_width=0.01))
    res["mh_ba"] = {"R": R.numpy(), "t": t.numpy(),
                    "p": gspmd.gather_dim0(p, ("dp", "sp"), gm2).numpy(),
                    "raw": raw, "log": log, "mesh": tuple(gm2.mesh.shape)}

    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        sys.exit(1)
