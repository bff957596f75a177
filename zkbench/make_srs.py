"""Write the frozen setup of a configuration: [tau^i] G1 and [L_i(tau)] G1
for i < n (the natural-order domain of n) and [tau] G2, worked out on
Python ints by the plain reference from the configuration's known tau.

    python3 zkbench/make_srs.py zkbench/configs/<config>.json
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from zkbench import inputs  # noqa: E402


def main(cfg_path: str) -> None:
    cfg = json.loads(Path(cfg_path).read_text())
    srs = inputs.make_srs(int(cfg["tau"], 16), cfg["srs_points"])
    inputs.save_srs(ROOT / cfg["srs_file"], srs, cfg["tau"])


if __name__ == "__main__":
    main(sys.argv[1])
