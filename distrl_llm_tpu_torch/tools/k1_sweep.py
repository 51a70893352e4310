#!/usr/bin/env python3
"""K1's design sweep at the rollout's [64, 152064]: cluster size x lookahead.

    python3 -m distrl_llm_tpu_torch.tools.k1_sweep [--seed S]

From the repository root. For each lookahead k in 1, 2 and 4 it builds
``csrc/fused_sample.cu`` with ``-DFUSED_SAMPLE_LOOKAHEAD=k`` (the package's
own build is k = 2) and launches it at every cluster size that holds the row
(4, 8 and 16 blocks, each block shaped by ``ops/sampling.py::_block``).
Before it is timed, each variant is checked under the greedy and train
settings: the lookahead changes no bit (at one cluster size, k = 1 and 4
must give the tokens and logprobs of k = 2), and k = 2 at each cluster size
(a cluster size is an order of sums) is held to the plain version with
``chip_smoke.py``'s tolerances: tokens equal except on near-tie rows,
logprobs within 1e-5. Then it is timed under the train setting as a CUDA
graph over logits copies past twice the L2, as ``chip_smoke.py`` times the
planned kernel. Prints one line per variant with how many of its clusters
the card holds at once, then the planned kernel's greedy time, each beside
the card's name and power limit. Needs one NVIDIA GPU and nvcc; exits 1 if
a variant disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

ROWS, VOCAB = 64, 152064
SETTINGS = (("greedy", 0.0, 0.95), ("train", 1.2, 0.95))
LOOKAHEADS = (2, 1, 4)  # the package's own first: the others must equal it
L2_BYTES = 50e6  # the H100's L2 cache
NEAR_TIE_REL = 1e-5  # chip_smoke.py's K1 tolerances
LOGP_ATOL = 1e-5


def graph_ms(calls, replays: int = 5) -> float:
    """Device ms per call of ``calls`` captured once into a CUDA graph and
    replayed ``replays`` times after a warm-up replay."""
    import torch

    for fn in calls[:2]:  # lazy initialisation outside the capture
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * len(calls))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    from distrl_llm_tpu_torch.ops import _build
    from distrl_llm_tpu_torch.ops import sampling as smp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    logits = (torch.randn((ROWS, VOCAB), generator=gen, device=dev) * 3.0).bfloat16().float()
    seeds = torch.randint(-2**31, 2**31, (ROWS,), generator=gen, device=dev, dtype=torch.int32)
    copies = int(2 * L2_BYTES // (logits.numel() * 4)) + 1
    sets = [logits] + [logits.clone() for _ in range(copies - 1)]
    plan = smp.plan_sample_cluster(ROWS, VOCAB)
    plain = {}
    for name, t, p in SETTINGS:
        top2 = smp.fused_sample_scores(logits, t, p, seeds).topk(2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]).abs() <= NEAR_TIE_REL * top2[:, 0].abs().clamp_min(1e-30)
        plain[name] = (smp.fused_sample_reference(logits, t, p, seeds)[0], tie)
    tok = torch.empty((ROWS,), dtype=torch.int32, device=dev)
    logp = torch.empty((ROWS,), dtype=torch.float32, device=dev)
    libs = {k: smp._declare(_build.load(
        "fused_sample", () if k == smp.LOOKAHEAD else (f"FUSED_SAMPLE_LOOKAHEAD={k}",)).lib)
        for k in LOOKAHEADS}
    for c in smp.CLUSTER_SIZES:
        if not smp._fits(VOCAB, c):
            continue
        cols, threads, _ = smp._block(VOCAB, c)
        first = {}
        for k, lib in libs.items():
            def launch(x, t, p, lib=lib, c=c, threads=threads, cols=cols):
                smp._raise_on(lib, lib.fused_sample_launch(
                    x.data_ptr(), t, p, seeds.data_ptr(), tok.data_ptr(), logp.data_ptr(),
                    ROWS, VOCAB, 16, c, threads, cols, 0,
                    torch.cuda.current_stream().cuda_stream), "variant launch")

            for name, t, p in SETTINGS:
                launch(logits, t, p)
                if k == smp.LOOKAHEAD:
                    want_tok, tie = plain[name]
                    err = float((logp - smp.token_logprob(logits, tok)).abs().max())
                    if not (bool(((tok == want_tok) | tie).all()) and err <= LOGP_ATOL):
                        print(f"k1_sweep: C {c} disagrees with the plain version under the "
                              f"{name} setting (|dlogp| {err:.3g})", file=sys.stderr)
                        return 1
                    first[name] = (tok.clone(), logp.clone())
                elif not (torch.equal(tok, first[name][0]) and torch.equal(logp, first[name][1])):
                    print(f"k1_sweep: C {c}, lookahead {k} gives other bits than lookahead "
                          f"{smp.LOOKAHEAD} under the {name} setting", file=sys.stderr)
                    return 1
            ms = graph_ms([lambda x=x: launch(x, 1.2, 0.95) for x in sets] * 2)
            active = ctypes.c_int(0)
            smp._raise_on(lib, lib.fused_sample_max_active_clusters(
                c, threads, cols, 0, ctypes.addressof(active)), "occupancy query")
            mark = " (the plan)" if (c, k) == (plan.cluster, smp.LOOKAHEAD) else ""
            print(f"K1 sweep [{ROWS},{VOCAB}] C {c} x {threads} threads, lookahead {k}{mark}: "
                  f"train {ms:.4f} ms (a CUDA graph over {copies} logits copies), "
                  f"{active.value} clusters at once; checked; {card}")
    ms = graph_ms([lambda x=x: smp.fused_sample(x, 0.0, 0.95, seeds) for x in sets] * 2)
    print(f"K1 [{ROWS},{VOCAB}] planned (C {plan.cluster}), greedy: {ms:.4f} ms (a CUDA graph "
          f"over {copies} logits copies); {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
