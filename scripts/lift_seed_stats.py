"""The lift experiment's seeds side by side: the port's on the H100 against
the JAX package's on the TPU, from the JSONs under ``experiments/``.

    python3 scripts/lift_seed_stats.py [--out F]

Mean AJI is the mean of the cytoplasm and nuclei AJI; a lift is a
teacher's (or student's) mean AJI less its seed's supervised student's, in
points. For the mt teacher's lift the script prints each seed's, each
platform's mean, sample standard deviation and standard error, and
z = (port mean - TPU mean) / sqrt(se_port**2 + se_TPU**2): |z| < 2 puts
the two means within two standard errors of their difference. Then the
component arms (mgd, psm) and the float32 arms at seed 0 the same way.

The port's files are ``experiments/h100_torch_lift_*.json`` (the tool's
JSONs, ``scripts/lift_runs_torch.sh`` and ``scripts/lift_sweep_torch.sh``);
the TPU's are ``experiments/lift_*.json``, and its seed-0 supervised
student, which ``lift_v4_seed0.json`` lacks, is RESULTS.md's (the "v3"
row of its seed-0 tables, mean AJI 0.4105).
"""

import argparse
import json
import math
import os

EXP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments")
# RESULTS.md, the seed-0 tables' supervised (v3) row: AJI nuclei and cytoplasm
TPU_SEED0_SUP = {"AJI_nuclei": 0.5564, "AJI_cyto": 0.2646}


def load(name):
    path = os.path.join(EXP, name)
    return json.load(open(path)) if os.path.exists(path) else {}


def mean_aji(row):
    return (row["AJI_cyto"] + row["AJI_nuclei"]) / 2.0


def stats(xs):
    n = len(xs)
    m = sum(xs) / n
    sd = math.sqrt(sum((x - m) ** 2 for x in xs) / (n - 1)) if n > 1 else float("nan")
    return {"n": n, "mean": m, "sd": sd, "se": sd / math.sqrt(n) if n > 1 else float("nan")}


def lifts(runs, sup, arm_key):
    """{seed: lift in points} of ``arm_key`` (e.g. "mt_teacher") against the
    seed's supervised student."""
    out = {}
    for seed, res in runs.items():
        if arm_key in res and seed in sup:
            out[seed] = 100.0 * (mean_aji(res[arm_key]) - mean_aji(sup[seed]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default="")
    args = ap.parse_args()
    port = {s: load(f"h100_torch_lift_v4_seed{s}.json") for s in range(5)}
    port = {s: r for s, r in port.items() if r}
    tpu = {s: load(f"lift_v4_seed{s}.json") for s in range(4)}
    port_sup = {s: r["sup_student"] for s, r in port.items() if "sup_student" in r}
    tpu_sup = {s: r["sup_student"] for s, r in tpu.items() if "sup_student" in r}
    tpu_sup.setdefault(0, TPU_SEED0_SUP)
    report = {"port_sup_mean_aji": {s: mean_aji(r) for s, r in port_sup.items()},
              "tpu_sup_mean_aji": {s: mean_aji(r) for s, r in tpu_sup.items()}}
    for arm in ("mt_teacher", "mt_student"):
        p, t = lifts(port, port_sup, arm), lifts(tpu, tpu_sup, arm)
        sp, st = stats(list(p.values())), stats(list(t.values()))
        z = (sp["mean"] - st["mean"]) / math.sqrt(sp["se"] ** 2 + st["se"] ** 2)
        report[arm] = {"port": p, "tpu": t, "port_stats": sp, "tpu_stats": st, "z": z}
    # the component arms: the port's at seeds 0, 1 and 3, the TPU's at seed 0
    comp = {}
    for arm in ("mgd", "psm", "odkd"):
        runs = {s: load(f"h100_torch_lift_{arm}_seed{s}.json") for s in range(5)}
        p = lifts({s: r for s, r in runs.items() if r}, port_sup, f"{arm}_teacher")
        tpu_runs = {0: {**load("lift_components_seed0.json"), **load("lift_odkd_seed0.json")}}
        comp[arm] = {"port": p, "port_stats": stats(list(p.values())) if p else None,
                     "tpu": lifts(tpu_runs, tpu_sup, f"{arm}_teacher")}
    report["components"] = comp
    f32 = load("h100_torch_lift_f32_seed0.json")
    if f32:
        sup32 = {0: f32["sup_student"]}
        report["f32_seed0"] = {arm: lifts({0: f32}, sup32, f"{arm}_teacher").get(0)
                               for arm in ("mt", "mgd")}
        report["f32_seed0"]["sup_mean_aji"] = mean_aji(f32["sup_student"])
    print(json.dumps(report, indent=1, default=float))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
