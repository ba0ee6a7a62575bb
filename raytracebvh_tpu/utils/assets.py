"""Asset resolution.

The reference hardcodes "Obj/Test.obj" (reference: Graphics.cpp:364).  We
resolve the same asset names against the directory named by RTBVH_OBJ_DIR
and the checkout's own ``assets/`` directory; ``None`` when absent.
Procedural scenes (models/procedural.py) need no files at all.
"""

from __future__ import annotations

import os

_REPO_ASSETS = os.path.join(os.path.dirname(__file__), "..", "..", "assets")


def find_asset(name: str) -> str | None:
    for d in (os.environ.get("RTBVH_OBJ_DIR", ""), _REPO_ASSETS):
        if not d:
            continue
        p = os.path.join(d, name)
        if os.path.isfile(p):
            return p
    return None
