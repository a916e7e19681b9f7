"""Genetic circuit-structure search CLI.

Counterpart of ``tneq_tpu/apps/structure_search.py`` (the reference's MPI
structure-search entry point, ``MPI_Overlord`` + ``MPI_Agent`` ranks via
mpiexec): one process drives the :class:`EvolutionSearch` work queue
against a goal circuit, with the reference's population/evolution knobs
exposed as flags, plus ``--device`` (default ``cuda``).  ``--devices N``
farms the candidates over the first N CUDA devices.  JAX's goal cores from
``PRNGKey(seed)`` become the port's ``init_params`` with ``seed``.

    python -m tneq_tpu_torch.apps.structure_search --device cpu --tn-size 3 \
        --population 4 --generations 2 --train-steps 20
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

from ..genetic import CandidateEvaluator, EvolutionSearch, Individual
from ..graph.dsl import parse_graph
from ..model.qctn import init_params

__all__ = ["build", "main"]


def build(argv: Optional[Sequence[str]] = None):
    """Parse and check the CLI's arguments; returns ``(args, evaluator,
    search_kwargs)``, the search that :func:`main` runs."""
    p = argparse.ArgumentParser(description="QCTN genetic structure search")
    p.add_argument("--tn-size", type=int, default=4,
                   help="qubits (= cores of the fully-connected template)")
    p.add_argument("--tn-rank", type=int, default=2)
    p.add_argument("--goal-graph", type=str, default=None,
                   help="DSL for the goal circuit (default: full connection)")
    p.add_argument("--template-graph", type=str, default=None,
                   help="DSL the population starts from (default: the goal "
                        "topology). Starting BELOW the goal's bond "
                        "dimensions with --tn-rank >= the goal's turns the "
                        "search into structure RECOVERY: mutations must "
                        "grow bonds to close the fidelity gap")
    p.add_argument("--population", type=int, default=8)
    p.add_argument("--generations", type=int, default=3)
    p.add_argument("--evaluate-repeat", type=int, default=2)
    p.add_argument("--top-k", type=int, default=3)
    p.add_argument("--n-copy", type=int, default=2)
    p.add_argument("--crossover-prob", type=float, default=0.0,
                   help="probability an offspring pair comes from "
                        "single-qubit-line crossover instead of mutation")
    p.add_argument("--mutation-weights", type=str, default=None,
                   help="comma triple 'bond,insert,remove' operator "
                        "probabilities (default uniform = reference "
                        "parity); bond-heavy weights accelerate recovery "
                        "searches whose goal differs only in bond ranks")
    p.add_argument("--mutations-per-child", type=int, default=1,
                   help="structural mutations per offspring (1 = reference "
                        "parity; >1 accelerates recovery searches whose "
                        "goal is many bond-growths away)")
    p.add_argument("--elitism", type=int, default=0,
                   help="carry this many top parents over unmutated each "
                        "generation (0 = reference parity: every offspring "
                        "is mutated, so per-generation best can regress)")
    p.add_argument("--train-steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--method", default="adam")
    p.add_argument("--loss", choices=["overlap_mse", "log_fidelity"],
                   default="overlap_mse",
                   help="candidate fitness objective: the reference raw "
                        "overlap MSE, or the scale-safe -log F (required "
                        "beyond ~24 qubits)")
    p.add_argument("--timeout", type=float, default=1800.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", type=str, default=None)
    p.add_argument("--devices", type=int, default=0,
                   help="farm candidates over the first N CUDA devices "
                        "(0 = serial on --device; the analogue of the "
                        "reference's one-agent-per-MPI-rank layout)")
    p.add_argument("--device", default="cuda",
                   help="device of the goal cores and the serial search "
                        "('cpu' runs on the host)")
    p.add_argument("--clear-caches-every", type=int, default=8,
                   help="drop the chunk and contraction-plan caches every N "
                        "generations (novel topologies accumulate entries; "
                        "0 = never)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="JSON checkpoint path; saved at each generation "
                        "boundary")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint instead of starting fresh")
    args = p.parse_args(argv)

    goal_src = args.goal_graph or Individual.create_full_connection(
        "goal", tn_size=args.tn_size, tn_rank=args.tn_rank
    ).graph.to_dsl()
    goal = parse_graph(goal_src)
    goal_params = init_params(goal, args.seed, torch.float32, device=args.device)
    template_src = args.template_graph or goal_src
    if args.template_graph:
        tmpl = parse_graph(template_src)
        if tmpl.nqubits != goal.nqubits:
            p.error(
                f"--template-graph has {tmpl.nqubits} qubits but the goal "
                f"has {goal.nqubits}; candidates must live on the goal's "
                f"qubits"
            )
    print(f"goal circuit: {goal.nqubits} qubits, {goal.ncores} cores")

    evaluator = CandidateEvaluator(
        goal, goal_params,
        max_iterations=args.train_steps,
        method=args.method,
        learning_rate=args.lr,
        timeout=args.timeout,
        loss=args.loss,
    )
    search_kwargs = dict(
        generation_property={
            "evaluate_repeat": args.evaluate_repeat,
            "society_property": {
                "society": [dict(n_individuals_span=args.population,
                                 graph_string_template=template_src)],
            },
        },
        evolution_property={"top_k": args.top_k, "n_copy": args.n_copy,
                            "crossover_prob": args.crossover_prob,
                            "elitism": args.elitism,
                            "mutations_per_child": args.mutations_per_child,
                            "mutation_weights": (
                                [float(x) for x in
                                 args.mutation_weights.split(",")]
                                if args.mutation_weights else None)},
        max_generation=args.generations,
        clear_caches_every=args.clear_caches_every,
        seed=args.seed,
        devices=([torch.device("cuda", i) for i in range(args.devices)]
                 if args.devices else None),
        tn_size=args.tn_size,
        tn_rank=args.tn_rank,
    )
    if args.resume:
        if not args.checkpoint:
            p.error("--resume requires --checkpoint")
        if not os.path.exists(args.checkpoint):
            p.error(f"checkpoint file not found: {args.checkpoint}")
    return args, evaluator, search_kwargs


def main(argv: Optional[Sequence[str]] = None):
    args, evaluator, search_kwargs = build(argv)
    if args.resume:
        search = EvolutionSearch.resume(args.checkpoint, evaluator,
                                        **search_kwargs)
    else:
        search = EvolutionSearch(
            evaluator, checkpoint_path=args.checkpoint, **search_kwargs
        )
    try:
        best = search.run()
    finally:
        if search.farm is not None:
            search.farm.shutdown()
    print(f"best individual {best.scope}: fitness={best.fitness_score:.5f} "
          f"sparsity={best.sparsity:.3f} "
          f"best_loss={min(best.report_loss):.5f}")
    print(best.graph.to_dsl())
    result = {
        "scope": best.scope,
        "fitness": best.fitness_score,
        "sparsity": best.sparsity,
        "losses": best.report_loss,
        "graph": best.graph.to_dsl(),
        "history": search.history,
    }
    if args.save:
        with open(args.save, "w") as f:
            json.dump(result, f, indent=2, default=str)
    return result


if __name__ == "__main__":
    main()
