"""Engine logging (analog of the reference's log/env_logger via RUST_LOG).

`SEQUILA_LOG=debug` turns on planner/operator decision logging, mirroring
the reference's `RUST_LOG=info` behavior (reference
sequila_query_planner.rs:22-26, sequila_physical_planner.rs:37-62)."""

from __future__ import annotations

import logging
import os

_CONFIGURED = False


def get_logger(name: str) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("SEQUILA_LOG", "warning").upper()
        logging.basicConfig(
            level=getattr(logging, level, logging.WARNING),
            format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        )
        _CONFIGURED = True
    return logging.getLogger(name)
