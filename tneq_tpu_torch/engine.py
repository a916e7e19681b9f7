"""EngineSiamese facade: the reference's engine API on the port.

Counterpart of ``tneq_tpu/engine.py``: ``generate_data``, the siamese
contraction and its gradient, the probability calculations and sampling,
backed by the port's contraction, feature, loss and inference modules.
JAX caches jitted programs per (graph signature, batch shapes); PyTorch
runs eagerly, so the engine caches the built contraction closures under
the same keys (their specs and contraction plans are the cost), in a
bounded LRU.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .graph.dsl import CircuitGraph
from .infer.probability import (
    _states_batched,
    conditional_probability,
    full_probability,
    marginal_probability,
)
from .infer.sampling import sample as _sample
from .model.qctn import QCTN
from .ops.compiler import compile_siamese
from .ops.contract import abs_square, make_siamese_fn
from .ops.features import generate_data as _generate_data
from .ops.scaling import scaled_siamese_fn
from .train.losses import nll_loss
from .utils.device import DeviceLike, resolve_device

__all__ = ["EngineSiamese"]


class _LRU:
    """Small bounded recency-ordered cache for built contraction closures
    (a loop over many topologies would otherwise grow without bound)."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._d: "OrderedDict[Any, Any]" = OrderedDict()

    def get(self, key):
        v = self._d.get(key)
        if v is not None:
            self._d.move_to_end(key)
        return v

    def put(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)


def _resolve(qctn: QCTN) -> Tuple[CircuitGraph, Dict]:
    if isinstance(qctn, QCTN):
        return qctn.graph, qctn.params
    raise TypeError("pass a QCTN (graph + params)")


def _rank_one(measures):
    """Rank-1 operators ``conj(φ) ⊗ φ`` from feature vectors φ."""
    return [torch.einsum("...k,...l->...kl", torch.conj(m), m) for m in measures]


def _born_scaled(raw: torch.Tensor, log_scale: torch.Tensor):
    if raw.is_complex():
        return abs_square(raw), 2.0 * log_scale
    return raw, log_scale


class EngineSiamese:
    def __init__(self, dtype: torch.dtype = torch.complex64, mx_K: int = 100,
                 use_scaling: bool = False, mesh=None, cache_size: int = 64,
                 device: DeviceLike = "cuda"):
        """``mx_K``: default Hermite order of :meth:`generate_data`;
        ``use_scaling``: contract through the log-scale path for deep
        networks; ``cache_size`` bounds the per-engine closure caches (LRU
        eviction); ``device`` holds the data and the default sampling
        generator.  ``mesh`` (``parallel.make_mesh``) with a 'model' axis
        routes the plain contraction through ``compile_siamese``'s
        bond-sliced strategy; the scaled path ignores it, as in JAX."""
        self.dtype = dtype
        self.mesh = mesh
        self.mx_K = mx_K
        self.use_scaling = use_scaling
        self.device = resolve_device(device)
        self._grad_cache = _LRU(cache_size)
        self._fwd_cache = _LRU(cache_size)

    # -- data --------------------------------------------------------------

    def generate_data(self, x, K: Optional[int] = None):
        """``(Mx_list, phi)`` for a data batch ``x [B, D]``, on the
        engine's device."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return _generate_data(x, K or self.mx_K, dtype=self.dtype)

    # -- contraction -------------------------------------------------------

    def contract_with_compiled_strategy(
        self,
        qctn: QCTN,
        circuit_states_list: Optional[Sequence] = None,
        measure_input_list: Sequence = (),
        measure_is_matrix: bool = True,
        ret_type: str = "tensor",
    ):
        """Born-rule contraction; complex results squared, as the reference
        does.  ``ret_type='scaled'`` returns ``(probs, log_scale)``."""
        if not measure_is_matrix:
            measure_input_list = _rank_one(measure_input_list)
        graph, params = _resolve(qctn)
        sb = _states_batched(circuit_states_list)
        scaled = self.use_scaling or ret_type == "scaled"
        key = ("fwd", graph.signature, sb, scaled,
               tuple(tuple(m.shape) for m in measure_input_list))
        fwd = self._fwd_cache.get(key)
        if fwd is None:
            with_states = circuit_states_list is not None
            if scaled:
                contract = scaled_siamese_fn(graph, with_states, sb)

                def fwd(params, states, measures):
                    return _born_scaled(*contract(params, states, measures))

            else:
                if self.mesh is not None:
                    contract, _ = compile_siamese(graph, mesh=self.mesh, states_batched=sb)
                else:
                    contract = make_siamese_fn(graph, with_states, sb)

                def fwd(params, states, measures):
                    raw = contract(params, states, measures)
                    return abs_square(raw) if raw.is_complex() else raw

            self._fwd_cache.put(key, fwd)
        out = fwd(params, circuit_states_list, list(measure_input_list))
        if scaled:
            probs, log_scale = out
            if ret_type == "scaled":
                return probs, log_scale
            return probs * torch.exp(log_scale)
        return out

    def contract_with_compiled_strategy_for_gradient(
        self,
        qctn: QCTN,
        circuit_states_list: Optional[Sequence] = None,
        measure_input_list: Sequence = (),
        measure_is_matrix: bool = True,
        ret: str = "dict",
    ) -> Tuple[torch.Tensor, Any]:
        """``(loss, grads)``: the NLL of the batch (``train/losses.nll_loss``,
        the log-scale correction detached) and its gradient by autograd.
        ``ret='dict'`` keys the gradients by core name; ``ret='list'``
        orders them as ``qctn.cores``.

        For complex cores the gradient is torch's: the conjugate of
        ``jax.grad``'s for the same real loss (ROADMAP §C)."""
        if not measure_is_matrix:
            measure_input_list = _rank_one(measure_input_list)
        graph, params = _resolve(qctn)
        sb = _states_batched(circuit_states_list)
        key = (graph.signature, sb, self.use_scaling,
               tuple(tuple(m.shape) for m in measure_input_list))
        loss_fn = self._grad_cache.get(key)
        if loss_fn is None:
            with_states = circuit_states_list is not None
            if self.use_scaling:
                contract = scaled_siamese_fn(graph, with_states, sb)

                def loss_fn(params, states, measures):
                    return nll_loss(*_born_scaled(*contract(params, states, measures)))

            else:
                contract = make_siamese_fn(graph, with_states, sb)

                def loss_fn(params, states, measures):
                    raw = contract(params, states, measures)
                    return nll_loss(abs_square(raw) if raw.is_complex() else raw)

            self._grad_cache.put(key, loss_fn)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, circuit_states_list, list(measure_input_list))
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        loss = loss.detach()
        if ret == "list":
            return loss, [grads[n] for n in qctn.cores]
        return loss, grads

    # -- probabilities -----------------------------------------------------

    def calculate_full_probability(self, qctn, circuit_states_list, measure_input_list):
        graph, params = _resolve(qctn)
        return full_probability(graph, params, circuit_states_list, measure_input_list)

    def calculate_marginal_probability(
        self, qctn, circuit_states_list, measure_input_list, qubit_indices
    ):
        graph, params = _resolve(qctn)
        return marginal_probability(
            graph, params, circuit_states_list, measure_input_list, qubit_indices
        )

    def calculate_conditional_probability(
        self, qctn, circuit_states_list, measure_input_list,
        qubit_indices, target_indices,
    ):
        graph, params = _resolve(qctn)
        return conditional_probability(
            graph, params, circuit_states_list, measure_input_list,
            qubit_indices, target_indices,
        )

    # -- sampling ----------------------------------------------------------

    def sample(
        self,
        qctn,
        circuit_states_list,
        num_samples: int,
        K: int,
        bounds=(-5.0, 5.0),
        grid_size: int = 1000,
        generator: Optional[torch.Generator] = None,
    ):
        """``[num_samples, nqubits]`` draws.  ``generator=None`` takes a
        generator on the engine's device seeded 0 (JAX: ``PRNGKey(0)``)."""
        graph, params = _resolve(qctn)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return _sample(
            graph, params, circuit_states_list, num_samples, K, generator,
            bounds=tuple(bounds), grid_size=grid_size, dtype=self.dtype,
        )
