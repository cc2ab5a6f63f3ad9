"""One append-one-json-line audit helper for every role.

The port's own copy of ``tpu_rl.obs.audit``, unchanged in behaviour.

Four call sites grew the same copy-pasted writer (learner rollback /
resume, colocated resume, population decisions) before this module
unified them. The semantics every caller relies on are preserved exactly:

- the directory is created on demand (``makedirs(exist_ok=True)``);
- one ``json.dumps(record) + "\\n"`` appended per call — O_APPEND writes
  of one short line, so concurrent writers interleave whole lines;
- ``OSError`` is swallowed: audit is best-effort, the action being
  audited already happened and a full disk must never take the run down.

``stamp=True`` (default) adds the wall-clock ``"t"`` key the original
writers all carried, without clobbering one the caller set itself.
"""

from __future__ import annotations

import json
import os
import time


def append_jsonl(
    result_dir: str | None, filename: str, record: dict, stamp: bool = True
) -> bool:
    """Append one JSON line to ``result_dir/filename``; True if written."""
    if result_dir is None:
        return False
    if stamp and "t" not in record:
        record = {**record, "t": time.time()}
    try:
        os.makedirs(result_dir, exist_ok=True)
        with open(os.path.join(result_dir, filename), "a") as f:
            f.write(json.dumps(record) + "\n")
    except OSError:
        return False  # audit is best-effort; the action already happened
    return True


def append_resume(result_dir: str | None, idx: int, epoch: int) -> bool:
    """The ONE resume-audit schema (``learner_resume.jsonl``) — the
    distributed learner and the colocated loop must emit identical records
    (pinned by test), so the record shape lives here, not at either site."""
    return append_jsonl(
        result_dir, "learner_resume.jsonl", {"idx": int(idx), "epoch": int(epoch)}
    )
