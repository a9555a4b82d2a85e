"""K2 (prox_update) and K3 (opt_update) where the training paths run them,
for the package of one checkout, on the card with nothing else running.

    python3 scripts/k2_k3_step_ab.py [--root DIR] [--json OUT]

``--root`` is a checkout whose ``src/repro_torch`` is measured (default:
this one); an older one unpacked in a gitignored directory (``git archive
<commit> | tar -x -C build/parent``) runs the same measurements, so one
chip call can compare the two (run parent, change, change, parent).  Each
checkout builds its own kernel library under its own ``build/``.

  * The optimizer step of a local step of the launcher's mlp (6 leaves)
    and of ResNet50 (full width, 153 leaves), K=4, in the donating
    executors' in-place form: sgd (K2), momentum with a bf16 buffer and
    sm3 (K3), each ``optimizer.step`` timed with CUDA events around
    back-to-back calls (no CPU twin in the way: the mlp's step is the
    wrapper's host cost), the K2/K3 kernels' device time from the
    profiler, and their launches a step.
  * ms per local step (the launcher's steady median) of ``train.main`` for
    mlp (sgd), mlp with momentum (bf16 buffer), mlp with sm3 and ResNet50
    (sgd), and of ``coda.fit`` for bf16 stablelm-1.6b CoDA at full width
    with 2 layers (chip_smoke.py's configuration), with the K2/K3 launches
    each path made.
"""
import argparse
import dataclasses
import json
import os
import statistics
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as CS  # noqa: E402

MLP_PATHS = {"mlp": [], "mlp_momentum": ["--optimizer", "momentum", "--opt-dtype", "bf16"],
             "mlp_sm3": ["--optimizer", "sm3"], "resnet50": CS.RN_ARGS}


# the model of each optimizer-step timing and its back-to-back calls
STEP_MODELS = {"mlp": 200, "resnet50": 20}


def optimizer_steps(dev, K2, K3, arch: str) -> dict:
    """The optimizer step of each optimizer over ``arch``'s parameters at
    K=4, in place."""
    from repro_torch.configs import get_config, mlp_config
    from repro_torch.core import coda, optimizer
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    cfg = mlp_config() if arch == "mlp" else get_config(arch)
    g = torch.Generator(device=dev).manual_seed(0)
    meta = M.init_params(cfg, device="meta")
    draw = lambda x: torch.randn((4, *x.shape), generator=g, device=dev)
    out = {}
    for name, opt_dtype, mod in (("sgd", torch.float32, K2), ("momentum", torch.bfloat16, K3),
                                 ("sm3", torch.float32, K3)):
        ccfg = coda.CoDAConfig(n_workers=4, optimizer=name, opt_dtype=opt_dtype)
        params, gp, ref = (tree_map(draw, meta) for _ in range(3))
        o = optimizer.for_config(ccfg)
        held = [o.init(ccfg, params)]

        def step():
            held.append(o.step(ccfg, held.pop(), params, gp, ref, 0.05, inplace=True)[1])

        before = mod.launches
        step()
        launches = mod.launches - before
        ms = CS.cuda_ms(step, iters=STEP_MODELS[arch])
        dev_ms, src = CS.kernel_device_ms(step, "prox_update" if mod is K2 else "opt_update",
                                          mod, calls=5)
        out[name] = {"ms": ms, "kernel_device_ms": dev_ms, "kernel_device_ms_source": src,
                     "launches_a_step": launches}
        print(f"{arch} optimizer step {name}: {ms:.3f} ms (CUDA events), K2/K3 "
              f"{CS.dev_txt(dev_ms, src)} in {launches} launches a step", flush=True)
        del params, gp, ref, held
        torch.cuda.empty_cache()
    return out


def bf16_stablelm_coda(dev, counted) -> dict:
    """chip_smoke.py's bf16 stablelm-1.6b CoDA fit (2 layers, K=4, B=32,
    S=64, one stage of 16 local steps)."""
    from repro_torch.configs import get_config
    from repro_torch.core import coda, schedules
    from repro_torch.data import ShardedDataset
    from repro_torch.launch import train
    c = CS.BF16_CODA
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=CS.TRAIN_LAYERS)
    ds = ShardedDataset(train.data_config_for(cfg, 0.71), c["n_data"], c["K"], seed=0,
                        target_p=0.71, device=dev)
    ccfg = coda.CoDAConfig(n_workers=c["K"], p_pos=ds.p_pos, param_dtype=torch.bfloat16)
    state = coda.init_state(cfg, ccfg, generator=torch.Generator().manual_seed(0), device=dev)
    sched = schedules.ScheduleConfig(n_workers=c["K"], eta0=0.5, T0=c["T0"], I0=c["I"],
                                     p_pos=ds.p_pos)
    before = counted()
    res = coda.fit(state, cfg, ccfg, sched, 1,
                   sample_window=lambda i: ds.sample_window(i, c["B"]),
                   sample_alpha_batch=ds.sample_alpha_batch)
    torch.cuda.synchronize()
    after = counted()
    out = {"ms_per_local_step": 1e3 * statistics.median(res.step_seconds[1:]),
           "local_steps": res.iterations,
           "launches": {k: after[k] - before[k] for k in after}}
    del res, state
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout to measure")
    ap.add_argument("--json", default="", help="write the results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_k3_step_ab: torch.cuda is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import disable_tf32
    from repro_torch.kernels import opt_update as K3
    from repro_torch.kernels import prox_update as K2
    from repro_torch.launch import train
    assert K2.__file__.startswith(root), (K2.__file__, root)
    disable_tf32()
    dev = torch.device("cuda:0")
    card = CS.nvidia_smi()
    print(f"k2_k3_step_ab: {root} on {card}", flush=True)
    counted = lambda: {"prox_update": K2.launches, "opt_update": K3.launches}
    res = {"root": root, "card": card,
           "optimizer_step": {a: optimizer_steps(dev, K2, K3, a) for a in STEP_MODELS},
           "paths": {}}
    for label, argv_ in MLP_PATHS.items():
        before = counted()
        out = train.main(list(argv_))
        after = counted()
        res["paths"][label] = {"ms_per_local_step": out["ms_per_local_step"],
                               "local_steps": out["iterations"],
                               "launches": {k: after[k] - before[k] for k in after}}
        del out
        torch.cuda.empty_cache()
    res["paths"]["bf16_stablelm_coda"] = bf16_stablelm_coda(dev, counted)
    for label, r in res["paths"].items():
        print(f"{label}: {r['ms_per_local_step']:.3f} ms per local step, {r['local_steps']} "
              f"local steps, K2/K3 launches {r['launches']}", flush=True)
    print(json.dumps({"k2_k3_step_ab": res}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
