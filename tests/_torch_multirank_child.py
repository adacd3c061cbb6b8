"""One rank of a ``tests/test_torch_multirank.py`` process group.

Run as ``python _torch_multirank_child.py JOB RANK WORLD DIR``: joins a
gloo group through ``file://DIR/group`` (not a TCP port: the test
workers run side by side), runs JOB's half of the check on the CPU with
one torch thread, and writes what the parent asserts to ``DIR`` as
``.npz`` (rank 0) plus ``imports-RANK.txt``, the list of imported
modules (the parent checks that no rank imported JAX or the
reference). Imports torch, numpy and ``repro_torch`` only.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

# ------------------------------------------------------------ lanes

N, M, H, S = 12, 3, 6, 3
KW = dict(lr=0.02, alloc_steps=30)


def _worlds():
    from repro_torch import data as tdata
    from repro_torch.core import cost_model as tcm
    out = []
    for seed in range(S):
        sp = tcm.SystemParams(n_devices=N, n_edges=M, L=2, Q=2)
        pop = tcm.sample_population(sp, seed=seed, device="cpu")
        X, y, Xt, yt = tdata.make_dataset("fmnist_syn", n_train=240,
                                          n_test=60, seed=0)
        fed = tdata.partition_noniid(X, y, Xt, yt, n_devices=N,
                                     size_range=(10, 16), seed=seed)
        out.append((pop, fed))
    return sp, out


def lanes(rank: int, world: int, out: str) -> None:
    """S=3 geo lanes over ``world`` ranks (one dead pad lane), host loop
    and fused, with the reference's initial weights and target."""
    from repro_torch.core import sweep as tsw
    from repro_torch.launch.mesh import sweep_mesh

    ref = np.load(os.path.join(out, "ref.npz"))
    names = sorted(k[len("init0/"):] for k in ref if k.startswith("init0/"))
    init = [{n: ref[f"init{s}/{n}"] for n in names} for s in range(S)]
    target, rounds = float(ref["target"]), int(ref["rounds"])
    sp, worlds = _worlds()
    mesh = sweep_mesh(device_type="cpu")
    res = {}
    for fused in (False, True):
        for shard in (True, False):
            if not shard and rank != 0:
                continue
            runner = tsw.SweepRunner(sp, worlds, init_params=init,
                                     device="cpu", shard=shard,
                                     mesh=mesh if shard else None, **KW)
            if shard:
                assert runner.S_pad == 4 and len(runner.lanes) == 4 // world
            scheds = [tsw.build_scheduler("fedavg", runner.feds[s], sp, H,
                                          seed=s, device="cpu")
                      for s in range(S)]
            r = runner.run(scheds, rounds, assign="geo", target_acc=target,
                           fused=fused)
            tag = (f"{'fused' if fused else 'host'}_"
                   f"{'shard' if shard else 'one'}")
            for k in ("acc", "T_i", "E_i", "iters"):
                res[f"{tag}/{k}"] = np.asarray(r[k])
            res[f"{tag}/H"] = np.asarray(r["H"])
    if rank == 0:
        np.savez(os.path.join(out, "lanes.npz"), **res)


# ------------------------------------------------------------ steps

FAMILIES = ("chatglm3-6b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
            "jamba-1.5-large-398b")
B, SEQ, LR, HFL_LR = 8, 16, 1e-3, 0.1


def _local_shape(shape, sharding):
    """The even block the rules give: each split dim divided by the
    sizes of the mesh dims that split it."""
    local = list(shape)
    for n, pl in zip(sharding.mesh.shape, sharding.placements):
        if pl.is_shard():
            local[pl.dim] //= n
    return tuple(local)


def steps(rank: int, world: int, out: str) -> None:
    """Every family's mesh train / prefill / decode steps on a (2, 2)
    data x model mesh and the two-tier step on (2, 1, 2) pod x data x
    model, each next to the one-process step on the same inputs."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import registry
    from repro_torch.launch import steps as TS
    from repro_torch.models import transformer as TT
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.sharder import NOOP, MeshSharder
    from repro_torch.utils import tree_leaves, tree_map

    dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    pm = init_device_mesh("cpu", (2, 1, 2),
                          mesh_dim_names=("pod", "data", "model"))
    res = {}
    for arch in FAMILIES:
        # a vocabulary the model axis divides, as every full config's: the
        # embedding and the logits split over it
        cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                  microbatches=2, vocab_size=256)
        params = TT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        gen = torch.Generator().manual_seed(1)
        tok = torch.randint(0, cfg.vocab_size, (B, SEQ), generator=gen,
                            dtype=torch.int32)
        lab = torch.randint(0, cfg.vocab_size, (B, SEQ), generator=gen,
                            dtype=torch.int32)
        batch = {"tokens": tok, "labels": lab}
        pshard = shd.param_shardings(params, cfg, dm)
        # the mesh dispatches MoE tokens in data x pod chunks, as the
        # reference's capacity is per data shard: the one-process step is
        # given the same chunks
        NOOP.data_chunks = 2

        # ---- train (adam)
        step, opt = TS.make_train_step(cfg, lr=LR)
        p1, _, m1 = step(params, opt.init(params), batch)
        mstep, mopt = TS.make_train_step(cfg, mesh=dm, lr=LR)
        dp = TS.shard_tree(params, pshard)
        db = TS.shard_tree(batch, TS.input_shardings(batch, dm))
        p2, _, m2 = mstep(dp, mopt.init(dp), db)
        res[f"{arch}/loss"] = np.array([m1["loss"].item(), m2["loss"].item()])
        diff = torch.cat([(a - b.full_tensor()).abs().ravel() for a, b in
                          zip(tree_leaves(p1), tree_leaves(p2))])
        res[f"{arch}/adam_share"] = np.array((diff > 1e-6).float().mean())
        res[f"{arch}/adam_max"] = np.array(diff.max())
        shapes_ok = all(
            tuple(p.to_local().shape) == _local_shape(p.shape, sh)
            and tuple(p.placements) == tuple(sh.placements)
            for p, sh in zip(tree_leaves(p2), _sh_leaves(pshard)))
        with implicit_replication():
            grads, _ = TS.accumulate_grads(
                cfg, dp, db, sharder=MeshSharder(dm, shd.act_rules(cfg, dm)))
        shapes_ok &= all(
            tuple(g.to_local().shape) == _local_shape(g.shape, sh)
            for g, sh in zip(tree_leaves(grads), _sh_leaves(pshard)))
        res[f"{arch}/local_shapes_ok"] = np.array(shapes_ok)

        # ---- prefill and decode
        with torch.no_grad():
            want = want_prefill = TS.make_prefill_step(cfg)(
                params, {"tokens": tok})
            got = TS.make_prefill_step(cfg, mesh=dm)(
                dp, TS.shard_tree({"tokens": tok}, TS.input_shardings(
                    {"tokens": tok}, dm))).full_tensor()
            res[f"{arch}/prefill"] = np.array(
                [(want - got).abs().max().item(), want.abs().max().item()])
            cache = TT.init_cache(cfg, B, 8, device="cpu")
            dcache = TS.shard_tree(TT.init_cache(cfg, B, 8, device="cpu"),
                                   shd.cache_shardings(cache, cfg, dm))
            one, meshed = TS.make_serve_step(cfg), TS.make_serve_step(
                cfg, mesh=dm)
            worst = []
            for t in range(3):
                tk = tok[:, t:t + 1]
                want, cache = one(params, cache, tk, t)
                dtk = TS.shard_tree(tk, TS.input_shardings(tk, dm))
                got, dcache = meshed(dp, dcache, dtk, t)
                got = got.full_tensor()
                worst.append([(want - got).abs().max().item(),
                              want.abs().max().item()])
            res[f"{arch}/decode"] = np.array(worst)

            if cfg.family != "ssm":
                # the kernel attention through local_map (the plain
                # version here, on each rank's local q-head block)
                got = TS.make_prefill_step(cfg, "kernel", mesh=dm)(
                    dp, TS.shard_tree({"tokens": tok}, TS.input_shardings(
                        {"tokens": tok}, dm))).full_tensor()
                res[f"{arch}/prefill_kernel"] = np.array(
                    [(want_prefill - got).abs().max().item(),
                     want_prefill.abs().max().item()])

        # ---- the two-tier step (plain SGD), unsynced then synced
        NOOP.data_chunks = 1
        params1 = TT.init(torch.Generator().manual_seed(5), cfg, device="cpu")
        pp = tree_map(lambda a, b: torch.stack([a, b]), params, params1)
        hb = tree_map(lambda x: x.reshape(2, B // 2, *x.shape[1:]), batch)
        for sync in (False, True):
            want = TS.make_hfl_train_step(cfg, lr=HFL_LR)(
                tree_map(torch.clone, pp), hb, sync)
            dpp = TS.shard_tree(pp, TS.pod_param_shardings(pp, cfg, pm))
            dhb = TS.shard_tree(hb, TS.input_shardings(hb, pm, pods=True))
            got = TS.full_tree(TS.make_hfl_train_step(cfg, mesh=pm,
                                                      lr=HFL_LR)(dpp, dhb,
                                                                 sync))
            # each leaf: its excess over 1e-6 of its largest value plus
            # 1e-5 of its largest step
            res[f"{arch}/hfl_{sync}"] = np.array(max(
                ((a - b).abs().max() - 1e-6 * a.abs().max()
                 - 1e-5 * (a - a0).abs().max()).item()
                for a, b, a0 in zip(tree_leaves(want), tree_leaves(got),
                                    tree_leaves(pp))))
            pp = want
    res.update(_kernel_and_structs(dm))
    res.update(_clis(dm))
    if rank == 0:
        np.savez(os.path.join(out, "steps.npz"), **res)


def _kernel_and_structs(dm) -> dict:
    """A q-head block that cuts a kv group (6 q heads over 3 kv heads on
    2 model ranks) through the kernel path; the kernel's dispatcher
    refusing DTensors; the mesh structs' placements."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import steps as TS
    from repro_torch.models import transformer as TT
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils import tree_leaves

    res = {}
    cfg = dataclasses.replace(registry.get_smoke_config("chatglm3-6b"),
                              d_model=48, n_heads=6, n_kv_heads=3)
    params = TT.init(torch.Generator().manual_seed(2), cfg, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (B, SEQ),
                        generator=torch.Generator().manual_seed(3))
    dp = TS.shard_tree(params, shd.param_shardings(params, cfg, dm))
    dtok = TS.shard_tree({"tokens": tok}, TS.input_shardings(
        {"tokens": tok}, dm))
    with torch.no_grad():
        want = TS.make_prefill_step(cfg)(params, {"tokens": tok})
        got = TS.make_prefill_step(cfg, "kernel", mesh=dm)(dp, dtok)
        got = got.full_tensor()
    res["uneven_kernel"] = np.array([(want - got).abs().max().item(),
                                     want.abs().max().item()])
    q = dtok["tokens"].float()[..., None, None].expand(B, SEQ, 2, 4)
    try:
        fa.flash_attention(q, q, q)
        res["kernel_refuses_dtensor"] = np.array(False)
    except TypeError:
        res["kernel_refuses_dtensor"] = np.array(True)

    big = registry.get_config("chatglm3-6b")
    ps = TS.params_struct(big, mesh=dm)
    want_sh = _sh_leaves(shd.param_shardings(TS.params_struct(big), big, dm))
    ok = all(x.to_local().is_meta and tuple(x.placements) == sh.placements
             and tuple(x.to_local().shape) == _local_shape(x.shape, sh)
             for x, sh in zip(tree_leaves(ps), want_sh))
    st = TS.opt_state_struct(big, TS.make_optimizer(big), mesh=dm)
    ok &= all(tuple(m.placements) == sh.placements
              for name in ("m", "v")
              for m, sh in zip(tree_leaves(st[name]), want_sh))
    from repro_torch.optim import adafactor
    fac = TS.opt_state_struct(big, adafactor(1e-3), mesh=dm)["mom"]
    wq = fac["blocks"][0]["mix"]["wq"]          # (28, 4096, 4096)
    ok &= (tuple(wq["vr"].to_local().shape) == (28, 2048)
           and tuple(wq["vc"].to_local().shape) == (28, 2048))
    inp = TS.input_specs(big, INPUT_SHAPES["train_4k"], mesh=dm)
    ok &= all(tuple(x.to_local().shape) == (128, 4096)
              for x in inp.values())
    res["structs_ok"] = np.array(ok)
    return res


def _clis(dm) -> dict:
    """``launch.train`` and ``launch.serve_lm`` with ``--production-mesh``,
    the production mesh stood in for by ``dm`` and the group already up,
    next to their one-device runs."""
    from repro_torch.launch import serve_lm, train

    argv = ["--arch", "chatglm3-6b", "--smoke", "--device", "cpu"]
    t_argv = argv + ["--steps", "2", "--batch", "4", "--seq", "16",
                     "--log-every", "1"]
    s_argv = argv + ["--batch", "4", "--prompt-len", "4", "--gen", "4"]
    one_t = train.main(t_argv)["log"]
    one_s = serve_lm.main(s_argv)["tokens"]
    for mod in (train, serve_lm):
        mod.init_group = lambda device_type: torch.device(device_type)
        mod.make_production_mesh = lambda device_type: dm
    mesh_t = train.main(t_argv + ["--production-mesh"])["log"]
    mesh_s = serve_lm.main(s_argv + ["--production-mesh"])["tokens"]
    return {"cli_train": np.array([[a[1] for a in one_t],
                                   [a[1] for a in mesh_t]]),
            "cli_serve_equal": np.array(torch.equal(one_s, mesh_s))}


def _sh_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sh_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sh_leaves(v)]
    return [tree]


# ------------------------------------------------------- production mesh

def production(out: str) -> None:
    """``make_production_mesh`` on 256- and 512-rank fake groups (no
    peers: the fake backend answers every collective locally)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh
    res = {}
    for n, multi in ((256, False), (512, True)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        try:
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            res[f"{n}/shape"] = np.array(mesh.shape)
            res[f"{n}/names"] = np.array(mesh.mesh_dim_names)
            try:
                make_production_mesh(multi_pod=not multi, device_type="cpu")
                res[f"{n}/wrong_size_raised"] = np.array(False)
            except ValueError:
                res[f"{n}/wrong_size_raised"] = np.array(True)
        finally:
            dist.destroy_process_group()
    np.savez(os.path.join(out, "production.npz"), **res)


def main() -> None:
    job, rank, world, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4]
    torch.set_num_threads(1)
    if job == "production":
        production(out)
    else:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            out, "group"), rank=rank, world_size=world)
        try:
            {"lanes": lanes, "steps": steps}[job](rank, world, out)
        finally:
            dist.destroy_process_group()
    with open(os.path.join(out, f"imports-{rank}.txt"), "w") as f:
        f.write("\n".join(sorted(sys.modules)))


if __name__ == "__main__":
    main()
