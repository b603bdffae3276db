"""One rank of a torch.distributed run of the port's sharded paths, on the
CPU over gloo; started N times by tests/test_torch_{parallel,chain,dist_ba,
multihost}.py through `run_ranks`.

    python tests/torch_dist_runner.py IN.npz OUT_DIR RANK WORLD PORT

IN.npz holds a JSON `spec` (the case and its configuration) and the input
arrays; each rank writes OUT_DIR/rank{RANK}.npz with the whole result,
gathered from every rank. The children import no JAX: the tests hold the
results to the JAX package's in the pytest process.

Cases:
  phd    `steps` sharded PHD steps (parallel.mesh.make_sharded_step) from a
         whole initial state, the global draws given; writes the whole state
         after each step and the per-step best / ancestors;
  chain  sharded sweeps (parallel.chain.make_sharded_sweep) over a given
         smoother state, one per entry of `schedule` (causal, temperature);
  ba     the distributed Gauss-Newton (parallel.dist_ba), the factors
         partitioned here for WORLD shards.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent


def one_thread():
    """One intra-op thread in the pytest process for a module (use as a
    module fixture): its reference runs are many small eager ops, which
    threads only slow down when the test workers share the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_ranks(tmp_path, spec, arrays, world, timeout=120):
    """Run `world` ranks of this script on spec + arrays; returns each rank's
    result as a dict of arrays, in rank order."""
    inp = tmp_path / "in.npz"
    np.savez(inp, spec=json.dumps(spec), **arrays)
    from monorfs_tpu_torch.parallel.multihost import free_port

    port = free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(HERE.parent))
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_dist_runner.py"), str(inp),
                               str(tmp_path), str(r), str(world), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=str(HERE.parent))
             for r in range(world)]
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errors.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, errors
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def main(inp, out_dir, rank, world, port):
    import torch

    torch.set_num_threads(1)
    from monorfs_tpu_torch import convert
    from monorfs_tpu_torch.models import get as get_model
    from monorfs_tpu_torch.parallel import multihost

    data = dict(np.load(inp))
    spec = json.loads(str(data.pop("spec")))
    multihost.initialize(f"localhost:{port}", world, rank, device="cpu")
    try:
        dtype = getattr(torch, spec["dtype"])
        model = get_model(spec["model"])
        params = {k[8:]: v for k, v in data.items() if k.startswith("params__")}
        params = convert.phd_params(params, dtype=dtype, device="cpu") if params else None
        out = CASES[spec["case"]](spec, data, model, params, dtype)
    finally:
        multihost.shutdown()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)


def _phd(spec, data, model, params, dtype):
    import torch

    from monorfs_tpu_torch.parallel import make_mesh, make_sharded_step, mesh as pmesh, multihost
    from monorfs_tpu_torch.slam import phd

    mesh = make_mesh(device="cpu")
    pcfg = phd.PHDConfig(**spec["pcfg"])
    whole = phd.init_state(model, pcfg, data["pose0"], dtype, "cpu")
    state = multihost.shard_state_global(whole, mesh)
    # the helpers of a host-replicated value: my rows, or the whole value
    assert torch.equal(multihost.distribute(whole.pose, mesh), state.pose)
    assert torch.equal(multihost.replicated(whole.pose, mesh), whole.pose)
    step = make_sharded_step(model, pcfg, mesh, slam=spec.get("slam", True))
    t = lambda x: torch.as_tensor(x)
    out = {"best": [], "ancestor": [], "pose": [], "logweight": []}
    for i in range(spec["steps"]):
        state = step(params, state, t(data["odo"][i]).to(dtype), t(data["z"][i]).to(dtype),
                     t(data["zmask"][i]), t(data["normals"][i]).to(dtype), t(data["u"][i]).to(dtype))
        full = pmesh.gather_state(state, mesh)
        for k in ("pose", "logweight", "ancestor", "best"):
            out[k].append(getattr(full, k).numpy())
    out = {k: np.stack(v) for k, v in out.items()}
    out.update({f"maps_{n}": leaf.numpy() for n, leaf in zip(full.maps._fields, full.maps)})
    return out


def _chain(spec, data, model, params, dtype):
    import torch

    from monorfs_tpu_torch.parallel import chain
    from monorfs_tpu_torch.parallel import collectives as C
    from monorfs_tpu_torch.slam import loopy, phd

    mesh = chain.make_chain_mesh(device="cpu")
    lcfg = dict(spec["lcfg"])
    lcfg = loopy.LoopyConfig(inner=phd.PHDConfig(**lcfg.pop("inner")), **lcfg)
    t = lambda k: torch.as_tensor(data[k])
    state = loopy.LoopyState(*[t("state_" + f) for f in loopy.LoopyState._fields])
    state, odo, z, zm = chain.shard_loopy_inputs(mesh, state, t("odometry"), t("z"), t("z_mask"))
    sweeps = {c: chain.make_sharded_sweep(model, lcfg, mesh, causal=c) for c in (False, True)}
    for causal, temperature in spec["schedule"]:
        state = sweeps[causal](params, state, odo, z, zm, torch.tensor(temperature, dtype=dtype),
                               t("grad_clip"), t("grad_rate"), t("motion_cov"))
    comm = np.asarray(json.dumps(mesh.comm))  # the sweeps' own collectives
    out = {f: C.all_gather(mesh, x).numpy() for f, x in zip(state._fields, state)}
    out["comm"] = comm
    return out


def _ba(spec, data, model, params, dtype):
    import torch

    from monorfs_tpu_torch.parallel import collectives as C
    from monorfs_tpu_torch.parallel import dist_ba

    mesh = dist_ba.make_landmark_mesh(device="cpu")
    dcfg = dist_ba.DistBAConfig(**spec["dcfg"])
    fp, fl, fz, fm = dist_ba.partition_factors(dcfg, mesh.size, data["f_pose"], data["f_lm"],
                                               data["f_z"], data["f_mask"])
    lms, lmask, fp, fl, fz, fm = dist_ba.shard_ba_inputs(mesh, data["landmarks"], data["lm_mask"],
                                                         fp, fl, fz, fm)
    t = lambda k: torch.as_tensor(data[k])
    solve = dist_ba.make_dist_gauss_newton(model, dcfg, mesh)
    poses, lms = solve(t("poses"), int(data["n_poses"]), t("pose_fixed"), t("between"),
                       t("between_mask"), lms, lmask, fp, fl, fz, fm, t("minfo"), t("sinfo"))
    comm = np.asarray(json.dumps(mesh.comm))  # the solve's own collectives
    return {"poses": poses.numpy(), "landmarks": C.all_gather(mesh, lms).numpy(), "comm": comm}


CASES = {"phd": _phd, "chain": _chain, "ba": _ba}


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
