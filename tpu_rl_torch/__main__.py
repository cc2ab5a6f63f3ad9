"""CLI: ``python -m tpu_rl_torch <role> [options]`` — the port of
``tpu_rl``'s CLI for the roles of the distributed runtime.

Examples:
    python -m tpu_rl_torch local --env CartPole-v1 --algo PPO
    python -m tpu_rl_torch local --env CartPole-v1 --algo PPO --params p.json
    python -m tpu_rl_torch learner --params params.json --machines machines.json
    python -m tpu_rl_torch manager --machines machines.json --machine-idx 0
    python -m tpu_rl_torch worker  --machines machines.json --machine-idx 0
    python -m tpu_rl_torch local --env-mode colocated --sebulba-split 1
    python -m tpu_rl_torch population --env-mode colocated \
        --pop-spec 'lr:log[1e-4,1e-3] interval=50u k=2' --max-updates 200

The learner trains on the card (``learner_device="auto"``, the default) and
refuses to run without one; a params file with ``"learner_device": "cpu"``
runs it on the plain path on the CPU. There is no device flag, as in
``tpu_rl``. The population role runs the PBT controller in this process
(its members are its children); the autopilot role and the chaos flags
come with a later slice of the port.
"""

from __future__ import annotations

import argparse
import os
import sys

from tpu_rl_torch.config import Config, MachinesConfig, default_result_dirs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu_rl_torch")
    p.add_argument("role", choices=["local", "learner", "manager", "worker", "population"],
                   help="which role this host runs ('population' = the PBT controller "
                   "orchestrating K member runs; see tpu_rl_torch.population)")
    p.add_argument("--params", help="parameters.json-shaped config file")
    p.add_argument("--machines", help="machines.json-shaped topology file")
    p.add_argument("--machine-idx", type=int, default=0,
                   help="index into machines.workers for manager/worker roles")
    p.add_argument("--env", help="override env id")
    p.add_argument("--algo", help="override algorithm")
    p.add_argument("--env-mode", choices=["distributed", "colocated"], default=None,
                   help="'colocated' runs act -> env.step -> train in one "
                   "process on the device (device envs only; see tpu_rl_torch/envs)")
    p.add_argument("--colocated-envs", type=int, default=None,
                   help="env-batch size for colocated mode (0/unset = batch_size)")
    p.add_argument("--sebulba-split", type=int, default=None,
                   help="colocated mode: this many of the host's cards act, the rest "
                   "train, fed through a bounded queue of batches on the card "
                   "(Podracer's Sebulba); 0/unset = the colocated loop")
    p.add_argument("--sebulba-queue", type=int, default=None,
                   help="batch slots between the sebulba groups (2 = double buffering)")
    p.add_argument("--act-mode", choices=["local", "remote"], default=None,
                   help="'remote' routes worker acting through the learner's "
                   "inference service or fleet; 'local' acts on worker host cores")
    p.add_argument("--inference-replicas", type=int, default=None,
                   help="inference fleet size for act_mode=remote: replica 0 serves in "
                   "the learner, replicas 1..N-1 are supervised children fed by the "
                   "model broadcast (default 1 = the learner's one service)")
    p.add_argument("--inference-base-port", type=int, default=None,
                   help="first port of the fleet's consecutive replica port range "
                   "(0/unset = learner_port + 2)")
    p.add_argument("--inference-hedge-ms", type=int, default=None,
                   help="resend an unanswered inference request to a second replica "
                   "after this many ms (0/unset = only at the timeout: plain failover)")
    p.add_argument("--inference-mesh-data", type=int, default=None,
                   help="devices each inference replica splits its act batch over "
                   "(1/unset = one device)")
    p.add_argument("--inference-dtype", choices=["f32", "bf16", "int8"], default=None,
                   help="serving-param precision (default: f32)")
    p.add_argument("--inference-buckets", type=int, default=None,
                   help="smallest bucket of the power-of-two flush-shape "
                   "ladder; 0/unset = one padded shape")
    p.add_argument("--act-kernel", choices=["xla", "pallas"], default=None,
                   help="'pallas' acts through the fused act kernel (B3); "
                   "'xla' through the unfused module (default)")
    p.add_argument("--max-updates", type=int, default=None)
    p.add_argument("--publish-interval", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-result-dir", action="store_true",
                   help="disable tensorboard/checkpoint output")
    p.add_argument("--result-dir", default=None,
                   help="fixed result dir (checkpoints land in "
                   "<result-dir>/models; a rerun with the same dir resumes)")
    p.add_argument("--model-save-interval", type=int, default=None,
                   help="checkpoint every N learner updates")
    p.add_argument("--ckpt-keep", type=int, default=None,
                   help="committed checkpoints retained on disk (>= 1)")
    p.add_argument("--ckpt-sync", action="store_true",
                   help="blocking checkpoint saves on the update loop")
    p.add_argument("--resume-force", action="store_true",
                   help="resume even if the checkpoint's config fingerprint disagrees")
    p.add_argument("--telemetry-port", type=int, default=None,
                   help="serve /metrics and /healthz from the storage process "
                   "on this port (0/unset = off)")
    p.add_argument("--history-dir", default=None,
                   help="run-history store location (unset = result_dir/history)")
    p.add_argument("--history-chunk-s", type=float, default=None)
    p.add_argument("--history-retention-s", type=float, default=None)
    p.add_argument("--no-learn-diag", action="store_true",
                   help="disable the learning-dynamics plane")
    p.add_argument("--watchdog-diag", action="store_true",
                   help="feed approx-KL and negated ESS into the divergence watchdog")
    p.add_argument("--trace-sample-n", type=int, default=None,
                   help="sample every Nth worker tick into the fleet trace; 0 = off")
    p.add_argument("--transport", choices=["tcp", "shm", "auto"], default=None,
                   help="data-hop fabric of the fan-in: 'shm' routes same-host "
                   "hops through shared-memory rings, 'auto' where the peer is "
                   "loopback (default: tcp)")
    p.add_argument("--slo-spec", default=None,
                   help="declarative SLO rules (see tpu_rl_torch.obs.slo)")
    p.add_argument("--slo-fail-run", action="store_true",
                   help="exit nonzero (storage child) on a failing final SLO verdict")
    p.add_argument("--pop-spec", default=None,
                   help="PBT search space and schedule of the population role, e.g. "
                   "'lr:log[1e-4,1e-2] entropy_coef:lin[0,0.05] perturb=1.2,0.8 "
                   "interval=200u k=4' (see tpu_rl_torch.population.spec)")
    p.add_argument("--pop-seed", type=int, default=None,
                   help="seed of the population's sampling, mutation and selection")
    p.add_argument("--heartbeat-timeout", type=float, default=None)
    p.add_argument("--startup-grace", type=float, default=None)
    p.add_argument("--supervise-poll", type=float, default=None)
    p.add_argument("--max-restarts", type=int, default=None)
    return p


_OVERRIDES = (
    ("env", "env"), ("algo", "algo"), ("env_mode", "env_mode"),
    ("colocated_envs", "colocated_envs"), ("sebulba_split", "sebulba_split"),
    ("sebulba_queue", "sebulba_queue"), ("pop_spec", "pop_spec"), ("pop_seed", "pop_seed"),
    ("act_mode", "act_mode"),
    ("inference_replicas", "inference_replicas"), ("inference_hedge_ms", "inference_hedge_ms"),
    ("inference_mesh_data", "inference_mesh_data"),
    ("inference_base_port", "inference_base_port"), ("inference_dtype", "inference_dtype"),
    ("inference_buckets", "inference_buckets"), ("act_kernel", "act_kernel"),
    ("telemetry_port", "telemetry_port"), ("history_dir", "history_dir"),
    ("history_chunk_s", "history_chunk_s"), ("history_retention_s", "history_retention_s"),
    ("trace_sample_n", "trace_sample_n"), ("transport", "transport"),
    ("slo_spec", "slo_spec"), ("heartbeat_timeout", "heartbeat_timeout_s"),
    ("startup_grace", "startup_grace_s"), ("supervise_poll", "supervise_poll_s"),
    ("max_restarts", "max_restarts"), ("model_save_interval", "model_save_interval"),
    ("ckpt_keep", "ckpt_keep"),
)


def load_config(args: argparse.Namespace) -> tuple[Config, MachinesConfig]:
    cfg = Config.from_json(args.params) if args.params else Config()
    overrides = {
        field: getattr(args, flag) for flag, field in _OVERRIDES
        if getattr(args, flag) not in (None, "")
    }
    if args.no_learn_diag:
        overrides["learn_diag"] = False
    if args.watchdog_diag:
        overrides["watchdog_diag"] = True
    if args.slo_fail_run:
        overrides["slo_fail_run"] = True
    if args.result_dir is not None:
        overrides["result_dir"] = args.result_dir
        # a user-set model_dir still wins; otherwise a rerun with the same
        # result dir resumes from its checkpoints
        if cfg.model_dir is None:
            overrides["model_dir"] = os.path.join(args.result_dir, "models")
    if args.ckpt_sync:
        overrides["ckpt_async"] = False
    if args.resume_force:
        overrides["resume_force"] = True
    if overrides:
        cfg = cfg.replace(**overrides)
    machines = MachinesConfig.from_json(args.machines) if args.machines else MachinesConfig()
    return cfg, machines


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg, machines = load_config(args)

    # Probe env spaces once, in the parent.
    from tpu_rl_torch.runtime.env import probe_spaces

    if cfg.env_mode != "colocated":
        cfg = probe_spaces(cfg)
    if not args.no_result_dir and (cfg.result_dir is None or cfg.model_dir is None):
        result_dir, model_dir = default_result_dirs()
        cfg = cfg.replace(
            result_dir=cfg.result_dir or result_dir,
            model_dir=cfg.model_dir or model_dir,
        )

    from tpu_rl_torch.runtime import runner

    if args.role == "population":
        # The controller is the orchestrator: it runs in this process and
        # drives its own supervisor (the members are its children).
        ctrl = runner.population_role(cfg, machines, max_updates=args.max_updates)
        ctrl.install_signal_handlers()
        doc = ctrl.run()
        return 0 if doc.get("ok") else 1
    if cfg.env_mode == "colocated" and args.role in ("manager", "worker"):
        print(
            f"colocated mode has no {args.role} role: the envs live inside "
            "the device loop (use 'local' or 'learner')",
            file=sys.stderr,
        )
        return 2
    if cfg.env_mode == "colocated":
        sup = runner.colocated_role(cfg, machines, max_updates=args.max_updates, seed=args.seed)
    elif args.role == "local":
        sup = runner.local_cluster(
            cfg, machines, max_updates=args.max_updates,
            publish_interval=args.publish_interval, seed=args.seed,
        )
    elif args.role == "learner":
        sup = runner.learner_role(
            cfg, machines, max_updates=args.max_updates,
            publish_interval=args.publish_interval, seed=args.seed,
        )
    elif args.role == "manager":
        sup = runner.manager_role(cfg, machines, machine_idx=args.machine_idx)
    else:
        sup = runner.worker_role(cfg, machines, machine_idx=args.machine_idx, seed=args.seed)

    sup.install_signal_handlers()
    try:
        sup.loop()
    finally:
        sup.stop()
    # nonzero when the training child failed or a child ran out of restarts
    trainer = [c for c in sup.children if c.name in ("learner", "colocated")]
    failed = any(c.exhausted for c in sup.children) or any(
        c.proc.exitcode != 0 for c in trainer
    )
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
