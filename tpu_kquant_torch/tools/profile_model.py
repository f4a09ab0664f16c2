"""Profile one model of chip_smoke.py on the card: torch.profiler over a
512-token prefill and 8 decode steps, replayed from the captured step and
in the plain loop (chip_smoke.py:profile_steps), its fixture written once
under .cache/ as the smoke writes it:

    python3 -m tpu_kquant_torch.tools.profile_model --model llama3-8b --out DIR

Logs each run's wall time, device kernel time, busy share and top kernels
beside the card's name and power limit; the kernel tables go to
DIR/profile_*.txt. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]
MODELS = {  # name -> (fixtures config function, chip_smoke.py's fixture file)
    "tinyllama": ("tinyllama_1b_config", "tinyllama-1.1b-q4_k_m-seed0.gguf"),
    "llama3-8b": ("llama3_8b_config", "llama-3-8b-q4_k_m-seed0.gguf"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="llama3-8b")
    ap.add_argument("--out", type=Path, required=True, help="directory of the kernel tables")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_model needs a CUDA card")
    from tpu_kquant_torch.models import fixtures
    from tpu_kquant_torch.runtime.engine import InferenceEngine

    spec = importlib.util.spec_from_file_location("profile_smoke", TREE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    config, name = MODELS[args.model]
    dev = torch.device("cuda", 0)
    smoke.log(smoke.gpu_line())
    cfg, params, _ = smoke.load_fixture(getattr(fixtures, config)(), name, dev)
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=704, device=dev)
    smoke.profile_steps(eng, cfg, dev, args.out, tag=f"_{args.model}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
