"""Paper Figs. 5/6 experiment on the PyTorch port: federated CNN
learning curves under Type 1/2/3 non-iid, MKP scheduling vs random
selection.

Default is a budgeted run; pass --full for the paper-scale setting
(100 clients, 200 rounds). ``--data-plane device`` runs the
device-resident chunked round function (fl.round.make_fl_rounds_scan,
``--round-chunk`` rounds per call) instead of the host loop. The rounds
run on the card unless ``--device cpu`` is given.

Both trainers implement the ``core.lifecycle.Trainer`` protocol and the
run is driven through the stepped service lifecycle (submit/drain); the
final ``TaskState`` comes back in the result, so a caller could
checkpoint it mid-run (``lifecycle.save_state``) and resume later.

Run:  PYTHONPATH=src python examples/train_noniid_torch.py --kind mnist --noniid type1
"""
import argparse
import json
import os

from repro_torch.fl import run_fl_experiment
from repro_torch.fl.simulation import SimConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", default="mnist", choices=["mnist", "cifar"])
    ap.add_argument("--noniid", default="type1",
                    choices=["type1", "type2", "type3"])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--clients", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="paper-scale: 100 clients, 200 rounds")
    ap.add_argument("--out", default=None, help="write history JSON here")
    ap.add_argument("--data-plane", default="host",
                    choices=["host", "device"],
                    help="per-round host loop vs device-resident chunked "
                         "rounds")
    ap.add_argument("--round-chunk", type=int, default=8,
                    help="rounds per call (device plane)")
    ap.add_argument("--device", default="cuda",
                    help="where the rounds run (default: cuda)")
    args = ap.parse_args()
    if args.full:
        args.clients, args.rounds = 100, 200

    curves = {}
    for sched in ("mkp", "random"):
        out = run_fl_experiment(
            args.kind, args.noniid, n_clients=args.clients,
            rounds=args.rounds, scheduler=sched,
            n_train=80 * args.clients, n_test=1500, subset_size=10,
            sim=SimConfig(batch_size=16, local_steps=2, local_lr=0.15,
                          eval_every=5, dropout_rate=0.05, seed=0),
            data_plane=args.data_plane, round_chunk=args.round_chunk,
            device=args.device)
        accs = [(h["round"], h["accuracy"]) for h in out["history"]
                if "accuracy" in h]
        curves[sched] = {"accs": accs, "final": out["final_accuracy"]}
        state = out["state"]
        print(f"[{sched:6s}] final acc {out['final_accuracy']:.3f}  "
              f"({state.phase.name}, {state.global_round} rounds / "
              f"{state.period} periods)  "
              f"curve: {['%.2f' % a for _, a in accs]}")
    gain = curves["mkp"]["final"] - curves["random"]["final"]
    print(f"scheduling gain ({args.kind}/{args.noniid}): {gain:+.3f} "
          f"(paper: positive, larger for stronger non-iid)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        json.dump(curves, open(args.out, "w"), indent=1)


if __name__ == "__main__":
    main()
