"""CLI for the sensitivity calibration pass.

    python -m repro_torch.calibrate --arch qwen2.5-3b --fidelity 1e-2 \
        --out results/calib_qwen.json --plan-out results/plan_qwen.json

Runs the calibration sweep (method ``output`` by default, ``weight`` for
the free proxy) on the card unless ``--device`` says otherwise, writes
the versioned :class:`SensitivityProfile` artifact and, when
``--fidelity`` is given, the solved :class:`PrecisionPlan`. The flags are
those of the JAX package's ``python -m repro.calibrate``, plus
``--device``; its artifacts load in either package.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.calibrate",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help="model architecture (see repro_torch.configs)")
    ap.add_argument("--reduce", default="smoke",
                    choices=["smoke", "100m", "full"],
                    help="scale preset for the weights (default: smoke)")
    ap.add_argument("--method", choices=["output", "weight"],
                    default="output",
                    help="output = measured rel-L2 at the model output; "
                         "weight = free Frobenius-perturbation proxy")
    ap.add_argument("--fidelity", type=float, default=None,
                    help="max rel-L2 output error target; when given the "
                         "solved PrecisionPlan is emitted too")
    ap.add_argument("--seed", type=int, default=0,
                    help="calibration batch + init seed")
    ap.add_argument("--calib-batch", type=int, default=2)
    ap.add_argument("--calib-seq", type=int, default=16)
    ap.add_argument("--out", default=None,
                    help="write the SensitivityProfile JSON here")
    ap.add_argument("--plan-out", default=None,
                    help="write the PrecisionPlan JSON here "
                         "(requires --fidelity)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    if args.plan_out and args.fidelity is None:
        ap.error("--plan-out requires --fidelity")

    from repro_torch.calibrate import calibrate_model, calibration_batch
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.launch.train import scale_config
    from repro_torch.models.transformer import Model

    device = resolve_device(args.device)
    mcfg = scale_config(get_arch(args.arch), args.reduce)
    model = Model(mcfg)
    params = model.init(args.seed, device="cpu")   # host: the store's source
    batch = calibration_batch(mcfg, args.calib_batch, args.calib_seq,
                              seed=args.seed)
    # fidelity=inf when only profiling: the solver runs but stops at once
    prof, plan = calibrate_model(model, params,
                                 fidelity=args.fidelity or float("inf"),
                                 batch=batch, method=args.method,
                                 seed=args.seed, device=device)
    if args.out:
        prof.save(args.out)
        print(f"profile ({args.method}, {len(prof.units)} units) "
              f"-> {args.out}")
    if args.fidelity is not None:
        hist = plan.histogram()
        print(f"plan @ fidelity {args.fidelity:g}: "
              f"predicted_err {plan.predicted_err:.2e}, "
              f"stored {plan.stored_bytes / 1e6:.2f} MB, "
              f"units {json.dumps(hist)}")
        if args.plan_out:
            plan.save(args.plan_out)
            print(f"plan -> {args.plan_out}")
    if not args.out and args.fidelity is None:
        json.dump(json.loads(prof.to_json()), sys.stdout, indent=2)
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
