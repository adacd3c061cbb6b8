"""Serving demos for both service CLIs of the PyTorch port (the
counterpart of ``examples/serve_demo.py``).

    PYTHONPATH=src python examples/serve_demo_torch.py [--smoke] [--device cuda|cpu]

Full mode runs (1) the streaming async-HFL service
(``repro_torch.launch.serve``) under the bursty traffic preset and (2)
the batched LM decode server (``repro_torch.launch.serve_lm``) on
smoke-scale variants of two architectures, one attention-based and one
attention-free. ``--smoke`` is the bounded CI guard: just the streaming
HFL service on a tiny world. Each CLI runs as its own process on
``--device`` (``cuda`` by default; without a card it raises, and so
does the demo). Returns the commands it ran.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="bounded CI mode: streaming HFL serve only")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ran = []

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")]))

    def run(cmd):
        subprocess.run(cmd, check=True, env=env)
        ran.append(cmd)

    print("=== streaming async HFL service (smoke world) ===", flush=True)
    serve_cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
                 "--device", args.device]
    if not args.smoke:
        serve_cmd += ["--traffic", "bursty", "--buffer-size", "2"]
    run(serve_cmd)
    if args.smoke:
        return ran

    for arch in ("mistral-nemo-12b", "mamba2-2.7b"):
        print(f"\n=== serving {arch} (smoke config) ===", flush=True)
        run([sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
             arch, "--smoke", "--batch", "4", "--prompt-len", "16", "--gen",
             "32", "--device", args.device])
    return ran


if __name__ == "__main__":
    main()
