"""``chip_smoke.py``'s GAN card-against-CPU checks over many seeds: the DCGAN check ([23],
``check_dcgan_card_vs_cpu``) and the GAN-family check ([26], ``check_gan_family_card_vs_cpu``),
as they run (the card's step on the CPU step's fake batches and ReLU/LeakyReLU branches,
``taped_step``), and, with ``--own``, the DCGAN check with the card on its own fakes and
branches.

Each seed draws other batches and draws for the f32 models at their configs' widths; a
seed passes when the check does at its tolerances. A fake batch that the two devices
compute apart by f32 noise, or an activation within that noise of 0, sends a gradient down
the other slope without the replay: the ``own`` count shows how often that alone fails the
DCGAN check. Each check prints its worst errors per step or config; this script adds one
line per seed and check, then one JSON line that it also appends to
chiprun_out/gan_parity_seeds.jsonl. Needs a CUDA card; imports neither JAX nor the JAX
package.

    python3 scripts/gan_parity_seeds.py --seeds 40 --family_seeds 8
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke  # noqa: E402


def own_step(torch, model, batch, draws, tape, replay):
    """``taped_step`` without the tape: each device on its own fakes and branches."""
    tape["fake_err"] = 0.0
    return model.train_step(batch, **draws)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=12, help="seeds of the DCGAN check")
    parser.add_argument("--family_seeds", type=int, default=0,
                        help="seeds of the GAN-family check")
    parser.add_argument("--first", type=int, default=1000)
    parser.add_argument("--own", action="store_true",
                        help="also run the DCGAN check on the card's own fakes and branches")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    taped = chip_smoke.taped_step
    runs = [("dcgan_replayed", chip_smoke.check_dcgan_card_vs_cpu, taped, args.seeds),
            ("family_replayed", chip_smoke.check_gan_family_card_vs_cpu, taped,
             args.family_seeds)]
    if args.own:
        runs.append(("dcgan_own", chip_smoke.check_dcgan_card_vs_cpu, own_step, args.seeds))
    seeds, failed = {}, {}
    for run, check, step, n in runs:
        chip_smoke.taped_step = step
        seeds[run] = list(range(args.first, args.first + n))
        failed[run] = []
        for seed in seeds[run]:
            t0 = time.perf_counter()
            try:
                check(torch, seed=seed)
                ok = True
            except SystemExit:
                ok = False
                failed[run].append(seed)
            print(f"{run} seed {seed}: {'ok' if ok else 'FAIL'} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    chip_smoke.taped_step = taped
    line = json.dumps({"card": card, "first": args.first,
                       **{f"{run}_passed": len(seeds[run]) - len(failed[run]) for run in seeds},
                       **{f"{run}_of": len(seeds[run]) for run in seeds},
                       **{f"{run}_failed_seeds": failed[run] for run in seeds}})
    print(line, flush=True)
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "gan_parity_seeds.jsonl", "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
