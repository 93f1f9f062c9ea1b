"""256-sensor scale soak: roster-LRU eviction churn + async uploads under load.

Smaller soaks (8-16 sensors) stay far below the
64-key modal/SSI tracker-roster LRU cap, with the async uploader idle.
This drives the full-features gateway at 256 sensors (3 axes x 2 ODRs,
15% per-epoch delivery churn, the endurance fault mix) so:

* the (axis, fs, roster) tracker key space EXCEEDS the 64-key LRU cap and
  real evictions happen (``GatewayService.tracker_evictions > 0``) while
  the roster dicts stay capped;
* multi-group FDD/SSI alignment runs with ~40-sensor rosters per group
  (mixed-ODR decimation merging the two rates);
* the async upload manager carries every sensor's egress (the capability
  the reference stubbed, ``GT_FFT_v5.py:109-113``) with zero duplicate
  uploads through a hard mid-soak restart;
* every endurance gate (RSS/fd ceilings, closed-form compile bound,
  restart resume invariants) holds at 16x the usual scale.

Reference contract this scales past: per-sensor dict isolation
(``GT_FFT_v5.py:42-62``) - the design the batch API claims to beat.

Usage:
    python benchmarks/scale_soak.py [--sensors 256] [--epochs 20] \
        [--out result.json] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmarks.endurance import run_endurance  # noqa: E402


def run_scale(n_sensors: int = 256, epochs: int = 20, seed: int = 0) -> dict:
    result = run_endurance(
        n_sensors=n_sensors, epochs=epochs, seed=seed,
        sample_every=max(epochs // 8, 1), async_uploads=True,
    )
    result["metric"] = "gateway_scale_soak"
    # Scale-specific gates on top of the endurance ones: the roster key
    # space must have overflowed the LRU (evictions happened) yet stayed
    # capped, and the async path must have been exercised.
    result["scale_ok"] = (
        bool(result["ok"])
        and result["tracker_evictions"] > 0
        # BOTH tracker families must have been driven to the LRU cap (a
        # 0 here means the stage never actually ran at scale - the round-5
        # per-consumer alignment fix was found exactly this way)
        and result["roster_max"]["modal"] == 64
        and result["roster_max"]["ssi"] == 64
        and result["async_uploads"]
        and result["fdd_lines"] > 0
        and result["ssi_lines"] > 0
    )
    result["ok"] = result["scale_ok"]
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sensors", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--platform", default="",
                    help="jax platform to pin (e.g. 'cpu'); default: the "
                         "device JAX finds")
    args = ap.parse_args()
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from apda_fft_tpu.utils.benchtime import device_info

    result = run_scale(args.sensors, args.epochs, args.seed)
    result["device"] = device_info()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "samples"}))
    raise SystemExit(0 if result["ok"] else 1)


if __name__ == "__main__":
    main()
