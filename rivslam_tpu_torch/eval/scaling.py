"""Rank-mesh scaling harness (port of ``rivslam_tpu/eval/scaling.py``).

    python -m rivslam_tpu_torch.eval.scaling [--ranks N | --ranks 1,2,4]
        [--cpu] [--json OUT] [--frames 40] [--capacity 512] [--graph-k 512]
        [--repeats 3] [--no-pin] [--fleet-cores-per-rank 1]

Measures, for each world size n, in a world of n ranks (one process each,
started by this harness; ``dist/mesh.py``):

1. **Fleet replay, weak scaling** (``Engine.replay_fleet(mesh=)``): n
   independent sequences, one a rank over the ``data`` axis. Aggregate
   frames/s and the efficiency against n = 1. With pinning, each rank is
   held to its own host cores (``_fleet_pinned``) and the same n sequences
   also run as n separate world-1 processes (``_fleet_processes``).
2. **Model-parallel registration, strong scaling**
   (``dist_gn.sharded_register``): one exact registration with its source
   points split over the ``model`` axis, H/b summed per LM iteration.
   ms/solve against the local ``register``.
3. **The distributed global pose-graph solvers** at keyframe capacity:
   edge-sharded PCG (``dist_graph.solve_pose_graph_sharded``) and the
   submap-partitioned block-Schur
   (``block_schur.solve_pose_graph_schur_sharded``), against their local
   twins; each row holds the local chi2 beside the sharded one.
   ``_schur_phase_probe`` times one rank's share of each phase.

With ``--cpu`` the ranks are host processes joined by gloo: the rows are
labelled ``cpu-gloo`` (the JAX harness's virtual mesh is its counterpart).
They share the host's cores, so their efficiency measures the split and
the collectives, not a speedup. On the card each rank is one card joined
by NCCL; a host with one card stops at n = 1, and its rows carry the
card's name and power limit. The exit code is 1 when a distributed solver
does not reach its local twin's chi2 (``chi2_mismatches``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT_S = 900.0  # a world's rendezvous, each collective, and each world's processes


def _min_time(fn, repeats: int, sync) -> float:
    """Best-of-N wall time of fn(), ``sync()`` after each call."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return min(times)


def _drifted_loop_graph(K: int, L: int, n_active: int, dtype, device="cpu"):
    """A drifted circular trajectory with one exact loop edge (the JAX
    harness's problem, sized to capacity): an odometry chain with 1%
    relative-pose noise accumulating drift, the loop 0 <-> n-1 pulling it
    back."""
    from rivslam_tpu_torch.core import lie
    from rivslam_tpu_torch.loop import global_graph

    def so3(w):
        return lie.so3_exp(torch.tensor(w, dtype=torch.float64)).numpy()

    rng = np.random.default_rng(0)
    gt = [np.eye(4)]
    step = np.eye(4)
    step[:3, :3] = so3([0, 0, 2 * np.pi / n_active])
    step[0, 3] = 1.0
    for _ in range(1, n_active):
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)
    est, rels = [np.eye(4)], [np.eye(4)]
    for k in range(1, n_active):
        rel = np.linalg.inv(gt[k - 1]) @ gt[k]
        rel = rel @ lie.se3_exp(torch.as_tensor(rng.normal(size=6) * 0.01)).numpy()
        rels.append(rel)
        est.append(est[-1] @ rel)
    est, rels = np.stack(est), np.stack(rels)
    true_rel = np.linalg.inv(gt[0]) @ gt[n_active - 1]
    g = global_graph.PoseGraph.create(K, L, dtype=dtype, device=device)

    def put(field, rows, value):
        out = getattr(g, field).clone()
        out[rows] = torch.as_tensor(np.asarray(value), device=device).to(out.dtype)
        return out

    act = slice(0, n_active)
    return dataclasses.replace(
        g,
        R=put("R", act, est[:, :3, :3]), p=put("p", act, est[:, :3, 3]),
        node_mask=put("node_mask", act, True),
        odom_rel_R=put("odom_rel_R", act, rels[:, :3, :3]), odom_rel_p=put("odom_rel_p", act, rels[:, :3, 3]),
        odom_info=put("odom_info", act, np.eye(6) * 100.0),
        loop_i=put("loop_i", 0, 0), loop_j=put("loop_j", 0, n_active - 1),
        loop_rel_R=put("loop_rel_R", 0, true_rel[:3, :3]), loop_rel_p=put("loop_rel_p", 0, true_rel[:3, 3]),
        loop_info=put("loop_info", 0, np.eye(6) * 400.0), loop_mask=put("loop_mask", 0, True),
    )


def _inputs(frames, capacity, graph_k, imu_capacity, n_seq, device):
    """What every process of one run builds alike from fixed seeds: the
    fleet's stacked sequences, one registration problem and the drifted
    pose graph."""
    from rivslam_tpu_torch.core.config import RegistrationConfig
    from rivslam_tpu_torch.frontend import apdgicp
    from rivslam_tpu_torch.io import datasets, synthetic

    reg_cfg = RegistrationConfig()
    stacked = [datasets.stack_sequence(
        synthetic.simulate_sequence(n_frames=frames, seed=100 + i, radius=10.0, capacity=capacity)[0],
        capacity=capacity, imu_capacity=imu_capacity) for i in range(n_seq)]
    rng = np.random.default_rng(7)
    world = synthetic.make_world(rng, n_points=8000)
    T0 = np.eye(4)
    T0[:3, 3] = [0, 0, 2.0]
    T1 = T0.copy()
    T1[:3, 3] += [0.4, -0.2, 0.05]
    tgt = synthetic.observe(world, T0, rng, capacity=capacity, noise=0.01, device=device)
    src = synthetic.observe(world, T1, rng, capacity=capacity, noise=0.01, device=device)
    src_p = apdgicp.estimate_covariances(src.xyz[None], src.mask[None], reg_cfg)
    tgt_p = apdgicp.estimate_covariances(tgt.xyz[None], tgt.mask[None], reg_cfg)
    g = _drifted_loop_graph(graph_k, 8, graph_k - graph_k // 8, torch.float32, device)
    return reg_cfg, stacked, src_p, tgt_p, g


def _schur_blocks(graph_k: int, sblocks: int, n: int):
    """The submap count for n ranks: a divisor of graph_k that is a multiple
    of n, the one closest to the local run's ``sblocks``; None if there is
    none."""
    ok = [b for b in range(1, min(4 * sblocks, graph_k) + 1) if graph_k % b == 0 and b % n == 0]
    return min(ok, key=lambda b: abs(b - sblocks)) if ok else None


def _schur_phase_probe(g, S: int, n: int, gn_iters: int, repeats: int, sync) -> dict:
    """One rank's share of each per-iteration phase of the sharded
    block-Schur solve at n ranks, timed alone at the share's shapes: the
    chain edges' linearization (K/n edges), the block assembly and the
    interior elimination with back-substitution (S/n blocks), and the
    replicated separator solve. With the collective row, these give the
    per-iteration cost on n real devices: per-rank + replicated + comm."""
    from rivslam_tpu_torch.loop import block_schur as bs

    K, L = g.R.shape[0], g.loop_i.shape[0]
    B, Sn, Kn = K // S, S // n, K // n
    P = 2 * S + 2 * L
    Pdim = 6 * (P + 1)
    dtype, dev = g.p.dtype, g.p.device
    # rank 0's bookkeeping (a cost model: slot values do not change the cost)
    jg = torch.arange(Kn, device=dev)
    ei, ej = torch.clamp_min(jg - 1, 0), jg
    emask = g.node_mask[ei] & g.node_mask[ej] & (jg > 0)
    edge_blk = torch.where(emask & (jg % B != 0), torch.div(jg, B, rounding_mode="floor"), Sn)
    sep_local = ((jg % B == 0) | (jg % B == B - 1)).reshape(Sn, B)
    D = torch.repeat_interleave(~sep_local, 6, dim=1).to(dtype)
    blk = torch.div(jg, B, rounding_mode="floor")
    slot = torch.where(jg % B == 0, 2 * blk, torch.where(jg % B == B - 1, 2 * blk + 1, P))
    sdim = bs._dims(slot.reshape(Sn, B)).reshape(Sn, 6 * B)
    edges = (ei, ej, g.odom_rel_R[:Kn], g.odom_rel_p[:Kn], g.odom_info[:Kn], emask,
             torch.zeros(Kn, dtype=torch.bool, device=dev))

    def lin():
        for _ in range(gn_iters):
            ch = bs._edge_terms(g.R, g.p, *edges, 1.0)
        return ch

    ch = lin()
    Hb, gb = bs._assemble_chain_blocks(ch, ei % B, ej % B, edge_blk, Sn, B, dtype)
    Hb = Hb + torch.eye(6 * B, dtype=dtype, device=dev) * 1e-6

    def asm():
        for _ in range(gn_iters):
            bs._assemble_chain_blocks(ch, ei % B, ej % B, edge_blk, Sn, B, dtype)

    def elim():
        for _ in range(gn_iters):
            _, _, A, b = bs._eliminate_local(Hb, gb, D, sdim, Pdim)
            bs._back_substitute(A, b, torch.zeros(Pdim, dtype=dtype, device=dev), sdim, D)

    H_sep, g_sep, _, _ = bs._eliminate_local(Hb, gb, D, sdim, Pdim)
    H_sep = H_sep + torch.eye(Pdim, dtype=dtype, device=dev)

    def sep():
        for _ in range(gn_iters):
            bs._sep_solve(H_sep, -g_sep[:, None])

    t = {}
    for name, fn in (("lin", lin), ("asm", asm), ("elim", elim), ("sep", sep)):
        fn()
        sync()
        t[name] = _min_time(fn, repeats, sync)
    return {
        "ranks": n, "blocks_per_rank": Sn, "edges_per_rank": Kn,
        "chain_linearize_ms": 1e3 * t["lin"], "block_assembly_ms": 1e3 * t["asm"],
        "eliminate_backsub_ms": 1e3 * t["elim"], "sep_solve_replicated_ms": 1e3 * t["sep"],
        "per_rank_total_ms": 1e3 * (t["lin"] + t["asm"] + t["elim"]),
    }


def _fleet_probe(mesh, stacked, reg_cfg, frames: int, repeats: int, device, sync) -> dict:
    """The fleet point of one world: each rank replays its sequence of the
    n, all gathered; wall time on rank 0 between barriers."""
    import torch.distributed as dist

    from rivslam_tpu_torch import pipeline
    from rivslam_tpu_torch.core.config import EngineConfig

    n = len(stacked)
    batch = {k: np.stack([st[k] for st in stacked]) for k in stacked[0]}
    eng = pipeline.Engine(EngineConfig(registration=reg_cfg), seed=0, device=device)

    def run():
        dist.barrier()
        eng.replay_fleet(batch, mesh=mesh, axis="data")
        dist.barrier()

    run()  # the first replay captures the card's graphs
    t = _min_time(run, repeats, sync)
    return {"sequences": n, "aggregate_fps": n * frames / t, "ms_per_frame_per_seq": 1e3 * t / frames}


def _fleet_pinned(rank: int, cores: int, cores_per_rank: int) -> list[int]:
    """The host cores rank ``rank`` is held to: its own ``cores_per_rank``
    (wrapping past the host's ``cores``). Unpinned, one rank at n = 1 gets
    every core and the weak-scaling efficiency then measures core sharing,
    not the fleet path."""
    return [(rank * cores_per_rank + i) % cores for i in range(cores_per_rank)]


def _launch(args: list[str], cores: list[int] | None) -> subprocess.Popen:
    """A rank process of this module, its output in temporary files (a rank
    blocked on a full pipe would stall its world's collectives)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([_PKG_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", "rivslam_tpu_torch.eval.scaling", *args]
    if cores is not None:
        cmd = ["taskset", "-c", ",".join(map(str, cores)), *cmd]
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True, env=env)
    proc.logs = (out, err)
    return proc


def _communicate(procs) -> list[str]:
    """Each process's stdout; raises (after stopping them all) if one
    fails or they run past TIMEOUT_S seconds."""
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        outs = []
        for p in procs:
            for f in p.logs:
                f.seek(0)
            out, err = (f.read() for f in p.logs)
            if p.returncode != 0:
                raise RuntimeError(f"scaling rank process failed (rc {p.returncode}):\n{err[-3000:]}")
            outs.append(out)
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            for f in p.logs:
                f.close()


def _fleet_processes(n: int, cores: int, probe: dict) -> dict:
    """n concurrent world-1 processes, one sequence and one pinned core
    each: the process-isolated fleet, beside the n-rank world's."""
    procs = [_launch(["--rank-probe", json.dumps(dict(probe, world=1, rank=0, seq_offset=i, fleet_only=True, threads=1,
                                                      init_file=f"{probe['init_file']}.{i}"))],
                     [i % cores]) for i in range(n)]
    rows = [json.loads(o.strip().splitlines()[-1])["fleet"] for o in _communicate(procs)]
    return {"processes": n, "aggregate_fps": sum(r["aggregate_fps"] for r in rows),
            "per_process_fps": [r["aggregate_fps"] for r in rows], "oversubscribed": n > cores}


def _rank_main(p: dict) -> dict:
    """One rank of an n-rank world: the fleet, the collective, the
    model-parallel registration and the two distributed graph solvers; rank
    0 returns the row (with the local twins' chi2 at convergence)."""
    import torch.distributed as dist

    from rivslam_tpu_torch.dist import dist_gn, dist_graph, mesh as mesh_mod
    from rivslam_tpu_torch.loop import block_schur, global_graph

    torch.set_num_threads(p["threads"])
    n, rank = p["world"], p["rank"]
    device = torch.device(p["device"])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    mesh_mod.init_world("nccl" if device.type == "cuda" else "gloo", rank, n, p["init_file"], TIMEOUT_S)
    try:
        reg_cfg, stacked, src_p, tgt_p, g = _inputs(p["frames"], p["capacity"], p["graph_k"], p["imu_capacity"],
                                                    p["seq_offset"] + n, device)
        stacked = stacked[p["seq_offset"]:]
        row: dict = {"ranks": n}
        row["fleet"] = _fleet_probe(mesh_mod.make_mesh(n, 1), stacked, reg_cfg, p["frames"], p["repeats"],
                                    device, sync)
        if p.get("fleet_only"):
            return row
        repeats, gn_iters, graph_k = p["repeats"], p["gn_iters"], p["graph_k"]
        m = mesh_mod.make_mesh(1, n)
        group = m.get_group("model")

        if n > 1:
            # one all_reduce of the block-Schur reduced system, the largest
            # collective of an iteration: comm_estimate = its time x iterations
            nb_c = _schur_blocks(graph_k, p["sblocks"], n) or p["sblocks"]
            pdim = 6 * (2 * nb_c + 2 * int(g.loop_i.shape[0]) + 1)
            payload = torch.zeros((pdim, pdim + 1), dtype=torch.float32, device=device)
            mesh_mod.all_sum(payload, group)
            t_sum = _min_time(lambda: mesh_mod.all_sum(payload, group), repeats, sync)
            row["collective"] = {"schur_reduced_all_reduce_ms": 1e3 * t_sum,
                                 "payload_mb": pdim * (pdim + 1) * 4 / 1e6,
                                 "per_solve_comm_estimate_ms": 1e3 * t_sum * gn_iters}

        if p["capacity"] % n == 0:
            eye4 = torch.eye(4, dtype=src_p.xyz.dtype, device=device)[None]

            def reg():
                return dist_gn.sharded_register(src_p, tgt_p, eye4, reg_cfg, m)

            reg()
            t_reg = _min_time(reg, repeats, sync)
            row["sharded_register"] = {"ms": 1e3 * t_reg, "speedup_vs_local": p["local"]["register_ms"] / (1e3 * t_reg)}

        def pcg():
            return dist_graph.solve_pose_graph_sharded(g, m, gn_iters=gn_iters)

        chi2_d = float(pcg()[1])
        t_pcg = _min_time(pcg, repeats, sync)
        row["dist_pcg"] = {"ms": 1e3 * t_pcg, "speedup_vs_local": p["local"]["pcg_solve_ms"] / (1e3 * t_pcg),
                           "chi2": chi2_d, "chi2_local": p["local"]["pcg_chi2"],
                           "chi2_matches_local": bool(np.isclose(chi2_d, p["local"]["pcg_chi2"], rtol=1e-3))}

        nb = _schur_blocks(graph_k, p["sblocks"], n)
        if nb is None:
            row["dist_schur"] = {"skipped": f"no divisor of {graph_k} % {n}"}
        else:
            def schur(iters):
                return block_schur.solve_pose_graph_schur_sharded(g, m, num_blocks=nb, gn_iters=iters)

            schur(gn_iters)
            t_sch = _min_time(lambda: schur(gn_iters), repeats, sync)
            # equivalence at convergence: in float32 the trust region's path
            # is chaotic mid-descent (a last-bit difference in a sum flips an
            # accept), so both solvers are held to their converged chi2
            conv_iters = max(gn_iters, 12)
            chi2_s = float(schur(conv_iters)[1])
            dist.barrier()
            if rank == 0:
                chi2_l = float(block_schur.solve_pose_graph_schur(g, num_blocks=nb, gn_iters=conv_iters)[1])
                chi2_init = float(global_graph.linearize(g, 1.0)[-1])
                row["dist_schur"] = {
                    "ms": 1e3 * t_sch, "blocks": nb,
                    "speedup_vs_local": p["local"]["schur_solve_ms"] / (1e3 * t_sch),
                    "chi2_at_convergence": chi2_s, "chi2_local_at_convergence": chi2_l,
                    "convergence_iters": conv_iters, "chi2_rel_reduction": 1 - chi2_s / chi2_init,
                    "chi2_matches_local": bool(abs(chi2_s - chi2_l) <= 5e-3 * chi2_init
                                               and chi2_s < 1e-2 * chi2_init),
                }
        return row
    finally:
        dist.destroy_process_group()


def run_scaling(
    rank_counts,
    frames: int = 40,
    capacity: int = 512,
    graph_k: int = 512,
    repeats: int = 3,
    gn_iters: int = 6,
    imu_capacity: int = 16,
    pin_fleet: bool = True,
    fleet_cores_per_rank: int = 1,
    device="cuda",
) -> dict:
    """The scaling rows for each world size in ``rank_counts`` (on the card
    at most the number of cards), each measured in a world of that many
    rank processes; the local references in this process."""
    from rivslam_tpu_torch.core.device import resolve
    from rivslam_tpu_torch.eval.latency import _card
    from rivslam_tpu_torch.frontend import apdgicp
    from rivslam_tpu_torch.loop import block_schur, global_graph

    dev = resolve(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        rank_counts = [n for n in rank_counts if n <= torch.cuda.device_count()]
    out: dict = {
        "platform": "cpu-gloo" if dev.type == "cpu" else "cuda-nccl",
        "device": _card(dev), "rank_counts": list(rank_counts),
        "frames": frames, "capacity": capacity, "graph_k": graph_k,
    }
    reg_cfg, _, src_p, tgt_p, g = _inputs(frames, capacity, graph_k, imu_capacity, 0, dev)
    out["graph_chi2_initial"] = float(global_graph.linearize(g, 1.0)[-1])

    # ---- local (one-process) references
    eye4 = torch.eye(4, dtype=src_p.xyz.dtype, device=dev)[None]

    def reg():
        return apdgicp.register(src_p, tgt_p, eye4, reg_cfg)

    reg()
    t_reg = _min_time(reg, repeats, sync)
    _, chi2_pcg = global_graph.solve_pose_graph(g, gn_iters=gn_iters)
    t_pcg = _min_time(lambda: global_graph.solve_pose_graph(g, gn_iters=gn_iters), repeats, sync)
    sblocks = block_schur.effective_blocks(graph_k, 16)
    block_schur.solve_pose_graph_schur(g, num_blocks=sblocks, gn_iters=gn_iters)
    t_sch = _min_time(lambda: block_schur.solve_pose_graph_schur(g, num_blocks=sblocks, gn_iters=gn_iters),
                      repeats, sync)
    out["local"] = {"register_ms": 1e3 * t_reg, "pcg_solve_ms": 1e3 * t_pcg, "pcg_chi2": float(chi2_pcg),
                    "schur_solve_ms": 1e3 * t_sch, "schur_blocks": sblocks}
    print(json.dumps({"local": out["local"]}), flush=True)

    cores = os.cpu_count() or 1
    pinned = pin_fleet and dev.type == "cpu" and os.path.exists("/usr/bin/taskset")
    out["fleet_pinned_per_core"] = pinned
    probe = dict(frames=frames, capacity=capacity, graph_k=graph_k, imu_capacity=imu_capacity,
                 repeats=repeats, gn_iters=gn_iters, sblocks=sblocks, local=out["local"],
                 device=str(dev), seq_offset=0,
                 # a pinned rank runs one torch thread per core it holds
                 threads=fleet_cores_per_rank if pinned else torch.get_num_threads())
    results = []
    fleet_base = procfleet_base = None
    with tempfile.TemporaryDirectory() as tmp:
        for n in rank_counts:
            init_file = os.path.join(tmp, f"world{n}")
            procs = [_launch(["--rank-probe", json.dumps(dict(probe, world=n, rank=r, init_file=init_file))],
                             _fleet_pinned(r, cores, fleet_cores_per_rank) if pinned else None)
                     for r in range(n)]
            row = json.loads(_communicate(procs)[0].strip().splitlines()[-1])
            fl = row["fleet"]
            fleet_base = fleet_base or fl["aggregate_fps"]
            fl["weak_scaling_efficiency"] = fl["aggregate_fps"] / (fleet_base * n)
            if pinned:
                fl["pinned_cores_per_rank"] = fleet_cores_per_rank
                pf = _fleet_processes(n, cores, dict(probe, init_file=os.path.join(tmp, f"solo{n}")))
                procfleet_base = procfleet_base or pf["aggregate_fps"] / n
                pf["weak_scaling_efficiency"] = pf["aggregate_fps"] / (procfleet_base * n)
                row["process_fleet"] = pf
            nb = _schur_blocks(graph_k, sblocks, n)
            if nb is not None:
                row["schur_phases"] = _schur_phase_probe(g, nb, n, gn_iters, repeats, sync)
            results.append(row)
            print(json.dumps(row), flush=True)

    out["scaling"] = results
    mismatches = [f"{k}@{row['ranks']}ranks" for row in results for k in ("dist_pcg", "dist_schur")
                  if isinstance(row.get(k), dict) and row[k].get("chi2_matches_local") is False]
    out["chi2_mismatches"] = mismatches
    for m in mismatches:
        print(f"WARNING: {m}: the distributed solver's chi2 does NOT match its local twin", flush=True)
    return out


def _counts(spec: str) -> list[int]:
    """"1,2,4" as given; one number N as the powers of two below N, then N."""
    if "," in spec:
        return [int(x) for x in spec.split(",")]
    n = int(spec)
    return [k for k in (1, 2, 4, 8, 16, 32) if k < n] + [n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rivslam_tpu_torch.eval.scaling")
    ap.add_argument("--ranks", default=None,
                    help="world sizes: N (1, 2, 4, ... up to N) or a comma list; default 4 with --cpu, "
                    "else the number of cards")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the host CPU")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--graph-k", type=int, default=512)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--json", default=None)
    ap.add_argument("--no-pin", action="store_true", help="do not pin CPU ranks to their own cores")
    ap.add_argument("--fleet-cores-per-rank", type=int, default=1)
    ap.add_argument("--rank-probe", default=None, help=argparse.SUPPRESS)  # a rank process
    args = ap.parse_args(argv)

    if args.rank_probe:
        p = json.loads(args.rank_probe)
        row = _rank_main(p)
        if p["rank"] == 0:
            print(json.dumps(row), flush=True)
        return 0

    if args.ranks is None:
        args.ranks = "4" if args.cpu else str(max(1, torch.cuda.device_count()))
    out = run_scaling(_counts(args.ranks), frames=args.frames, capacity=args.capacity, graph_k=args.graph_k,
                      repeats=args.repeats, pin_fleet=not args.no_pin,
                      fleet_cores_per_rank=args.fleet_cores_per_rank, device="cpu" if args.cpu else "cuda")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 1 if out["chi2_mismatches"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
