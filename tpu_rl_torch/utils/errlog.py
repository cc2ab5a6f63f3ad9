"""Per-role crash logs — the port's copy of ``tpu_rl.utils.errlog``.

Any role process that dies on an exception leaves
``logs/<role>/error_log_<ts>.txt`` with the traceback, so post-mortems don't
depend on scrollback. The runner wraps every child target with
:func:`role_entry`.
"""

from __future__ import annotations

import datetime
import os
import traceback


def save_error_log(role: str, exc: BaseException, log_root: str = "logs") -> str:
    d = os.path.join(log_root, role)
    os.makedirs(d, exist_ok=True)
    ts = datetime.datetime.now().strftime("%d%m%Y_%H_%M_%S")
    path = os.path.join(d, f"error_log_{ts}.txt")
    with open(path, "w") as f:
        traceback.print_exception(exc, file=f)
    return path


def role_entry(target, role: str, log_root: str, *args, cpu_only: bool = False) -> None:
    """mp.Process target wrapper: run ``target(*args)``; on exception, write
    the crash log and re-raise (the supervisor sees a nonzero exit).

    A ``cpu_only`` child (worker, manager, storage; the learner when
    ``learner_device="cpu"``) runs :func:`~tpu_rl_torch.utils.platform.host_role`
    before the role's code, so it never opens a CUDA context. ``tpu_rl``'s
    restart-time accelerator probe, which degrades the learner to the CPU,
    is deliberately not ported: the learner on ``"auto"`` runs on the card
    or fails."""
    if cpu_only:
        from tpu_rl_torch.utils.platform import host_role

        host_role()
    try:
        target(*args)
    except BaseException as exc:  # noqa: BLE001 — log everything, incl. SystemExit
        if not isinstance(exc, (KeyboardInterrupt, SystemExit)):
            try:
                save_error_log(role, exc, log_root)
            except OSError:
                pass  # never mask the real failure with a logging error
            try:
                # Flight recorder (tpu_rl_torch.obs.flightrec): the role
                # installed one at startup when result_dir is set — dump its
                # span ring + config fingerprint next to the text log.
                from tpu_rl_torch.obs import flightrec

                flightrec.dump_on_crash(exc)
            except Exception:
                pass  # never mask the real failure with a recorder error
        raise
