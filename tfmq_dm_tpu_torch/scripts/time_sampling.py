"""Time two host-bound paths of ``chip_smoke.py``'s phase main on the card
at CIFAR-10 width, from the trained ``runs/cifar10_ddpm.npz``:

- ``fsc_s``: the calibration's init pass (``cali_model`` with minmax
  weight grids and the mse activation scaler, no reconstruction) on a
  10-step harvest of 8 rows, the 80-grid search at every site and step;
- ``sample_s``: ``cli.main --ptq --use_aq --int-kernels --int4-serving``
  from that artifact, 8 images, 10 DDIM steps (load, deploy and sample).

    python tfmq_dm_tpu_torch/scripts/time_sampling.py [--root CHECKOUT]
        [--repeats 3]

``--root`` imports ``tfmq_dm_tpu_torch`` from another checkout (default:
the one this file is in), so that two versions can be timed one after
the other on one card, each in a process of its own. Prints the card's
name and power limit, the package's path, then ``fsc_s <seconds>`` once
a repeat and ``sample_s <seconds>`` once a repeat; the first of each
includes first launches.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
STEPS, BATCH, SEED = 10, 8, 1234


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2

    def mod(name):
        return importlib.import_module(f"tfmq_dm_tpu_torch.{name}")

    cli = mod("cli")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"tfmq_dm_tpu_torch from {Path(cli.__file__).parent}", flush=True)
    ckpt = str(REPO / "runs" / "cifar10_ddpm.npz")
    dev = torch.device("cuda")
    ddim_unet = mod("models.ddim_unet")
    cfg = ddim_unet.cifar10_config()
    params, _ = mod("convert").load_params(ckpt, device=dev)
    betas, seq = cli.cifar10_schedule(STEPS)
    x = torch.randn((BATCH, 32, 32, 3),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    xs, ts = mod("samplers.ddim").harvest_trajectory(
        lambda x, t, s: ddim_unet.apply(params, cfg, x, t), betas, seq, x)
    adapter = mod("models.ddim_units").build_adapter(cfg, w_bits=4,
                                                     a_bits=8)
    with tempfile.TemporaryDirectory() as tmp:
        art = str(Path(tmp) / "cali.npz")
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod("quant.calibrate").cali_model(
                adapter, params, None, (xs, ts), hp=None, use_aq=True,
                running_stat=False,
                generator=torch.Generator().manual_seed(2), path=art,
                w_scaler="minmax", act_scaler="mse", init_samples=BATCH,
                meta={"wq": 4, "aq": 8,
                      "cali_t": [float(v) for v in seq[::-1]]})
            torch.cuda.synchronize()
            print(f"fsc_s {time.perf_counter() - t0:.4f}", flush=True)
        del params, xs, ts
        argv = ["--task", "cifar10", "--ckpt", ckpt, "--timesteps",
                str(STEPS), "-n", str(BATCH), "--batch", str(BATCH),
                "--seed", str(SEED), "--device", "cuda", "--ptq",
                "--cali_ckpt", art, "--use_aq", "--int-kernels",
                "--int4-serving", "--out", str(Path(tmp) / "out")]
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise RuntimeError("cli.main failed")
            torch.cuda.synchronize()
            print(f"sample_s {time.perf_counter() - t0:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
