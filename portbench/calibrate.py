"""Readings for setting the check's limits, at a cell's own sizes, one
process for many seeds:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--program] [--control] [--fault half_batch]

For each seed it prints one JSON line with the numbers ``portbench.check``
compares: ``program`` (the port's first updates against the reference),
``control`` (the reference in TF32, the precision below the configuration's
float32, in the program's place) and ``fault`` (the port with a fault
planted). The program and its faults run on one card, so a cell on several
cards gives its control readings here and its program and fault readings
from runs of ``portbench.run``. ``kinks`` counts the first update's kinks
(``portbench.reference.losses``); ``program_way`` says which of the
reference's ways the program lies closest to (0: each kink on the side the
reference puts it).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import torch

    from portbench import check, spec
    from portbench.program import Program
    from portbench.run import first_updates, reference
    from portbench.traffic import make_batch, pool_size
    from portbench.weights import make_weights

    bench = spec.load_benchmark()
    cell = spec.find(bench["workloads"], args.workload, "workload")
    conf = spec.load_config(bench, cell["config"])
    mix = spec.load_traffic(cell["traffic"])
    cfg = conf["config"]
    device = torch.device(args.device)
    runs = ([None] if args.program else []) + ([args.fault] if args.fault else [])
    for seed in (int(s) for s in args.seeds.split(",")):
        weights = make_weights(cfg, conf["architecture"], seed, device)
        ref = reference(conf, mix, seed, weights, device, "float32")
        out = {"seed": seed, "kinks": ref["kinks"], "reference_losses": ref["variants"][0]["loss"],
               "loss_scales": ref["variants"][0]["scale"]}
        for fault in runs:
            program = Program(cfg, weights, device, fault)
            fields = [make_batch(cfg, mix, seed, 0, device)]
            fields += [make_batch(cfg, mix, seed, i, device)
                       for i in range(1, min(4, pool_size(fields[0], mix)))]
            losses, grads, changes = first_updates(
                program, [program.batch(f) for f in fields], weights, conf["check"]["updates"])
            ways = [check.way_readings(losses, grads, changes, w) for w in ref["variants"]]
            best = min(range(len(ways)), key=lambda i: max(ways[i].values()))
            out[fault or "program"] = ways[best]
            out[(fault or "program") + "_way"] = best  # 0: every kink as the reference puts it
            out[(fault or "program") + "_losses"] = losses
            del program, fields
            if device.type == "cuda":
                torch.cuda.empty_cache()
        if args.control:
            ctl = reference(conf, mix, seed, weights, device, "tf32")["variants"][0]
            out["control_losses"] = ctl["loss"]
            out["control"] = check.readings(ctl["loss"], ctl["grad_norms"], ctl["change_norms"],
                                            ref)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
