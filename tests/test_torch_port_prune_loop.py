"""The port's whole prune loop against the JAX package's, on the CPU:
``run_prune_retrain`` on ``bert_glue_sensitivity --smoke`` (as shipped
and with one fine-tune epoch), ``llama3_ffn_taylor``,
``mnist_mlp_shapley``, ``vit_head_mlp_shapley`` and ``resnet50_taylor
--smoke``, the port's init monkeypatched to the JAX init weights and
state and its Shapley permutations to the JAX ones.

The loop's losses and accuracies agree to 1e-4 after up to 1,250 SGD
steps; drop-index sets may differ only where scores tie within
tolerance at the cut.  These cases are the longest of the port's tests,
so they sit in a file of their own: pytest-xdist's ``--dist loadfile``
then runs them on a worker beside the rest of the port's tests.
"""

import dataclasses

import _torch_threads  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

from torchpruner_tpu.core.segment import init_model as j_init_model
from torchpruner_tpu.data import datasets as JD
from torchpruner_tpu.experiments import presets as JPS
from torchpruner_tpu.experiments import prune_retrain as JPR
from torchpruner_tpu_torch import attributions as PA
from torchpruner_tpu_torch.convert import params_from_numpy
from torchpruner_tpu_torch.core import segment as PS
from torchpruner_tpu_torch.data import datasets as PD
from torchpruner_tpu_torch.experiments import presets as PPS
from torchpruner_tpu_torch.experiments import prune_retrain as PPR

from test_torch_port_prune import jax_perms


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


#: (preset, fine-tune epochs; None = the preset's own), all --smoke; the
#: two BERT cases keep the ids they had when the test held only BERT
LOOP_CASES = [
    pytest.param("bert_glue_sensitivity", 0, id="0"),
    pytest.param("bert_glue_sensitivity", 1, id="1"),
    pytest.param("llama3_ffn_taylor", None, id="llama3_ffn_taylor"),
    pytest.param("mnist_mlp_shapley", None, id="mnist_mlp_shapley"),
    pytest.param("vit_head_mlp_shapley", None, id="vit_head_mlp_shapley"),
    pytest.param("resnet50_taylor", None, id="resnet50_taylor"),
]

#: splits injected into both loops, (split, examples): resnet20_cifar's
#: cifar10 fallback is 50,000 / 10,000 synthetic images, whose
#: evaluation each round would take minutes on the CPU
LOOP_SPLITS = {"resnet50_taylor": (("train", 256), ("val", 64),
                                   ("test", 500))}


@pytest.mark.parametrize("preset,finetune", LOOP_CASES)
def test_prune_retrain_loop_matches_jax(preset, finetune, tmp_path,
                                        monkeypatch):
    """The port's loop from the JAX initial weights and BatchNorm state
    (and, for Shapley, the JAX permutations) against the JAX loop:
    layers, widths, units dropped, params, and pre/post losses and
    accuracies to 1e-4."""
    over = {} if finetune is None else {"finetune_epochs": finetune}
    cfg_j = dataclasses.replace(JPS.get_preset(preset, smoke=True), **over,
                                log_path=str(tmp_path / "j.csv"))
    cfg_p = dataclasses.replace(PPS.get_preset(preset, smoke=True), **over,
                                log_path=str(tmp_path / "p.csv"))
    splits = LOOP_SPLITS.get(preset)
    datasets = {pkg: None if splits is None else tuple(
        load(cfg_j.dataset, s, n=n, seed=cfg_j.seed) for s, n in splits)
        for pkg, load in (("jax", JD.load_dataset), ("port", PD.load_dataset))}
    j_hist = JPR.run_prune_retrain(cfg_j, verbose=False,
                                   datasets=datasets["jax"])
    j_model = JPR.MODEL_REGISTRY[cfg_j.model][0]

    def jax_init(model, seed=0, dtype=torch.float32, device=None):
        jparams, jstate = j_init_model(j_model(), seed=seed)
        return (params_from_numpy(numpy_tree(jparams), device=device),
                params_from_numpy(numpy_tree(jstate), device=device))

    def draw(self, n, S):
        self._calls += 1
        return jax_perms(self.seed, self._calls, n, S)

    monkeypatch.setattr(PS, "init_model", jax_init)
    monkeypatch.setattr(PA.ShapleyAttributionMetric, "_draw_perms", draw)
    p_hist = PPR.run_prune_retrain(cfg_p, verbose=False, device="cpu",
                                   datasets=datasets["port"])
    assert [r.layer for r in p_hist] == [r.layer for r in j_hist]
    assert len(p_hist) == {"vit_head_mlp_shapley": 4,
                           "resnet50_taylor": 9}.get(preset, 2)
    for p, j in zip(p_hist, j_hist):
        assert p.widths == j.widths and p.n_dropped == j.n_dropped
        assert p.n_params == j.n_params
        for f in ("pre_loss", "pre_acc", "post_loss", "post_acc"):
            assert abs(getattr(p, f) - getattr(j, f)) <= 1e-4, (
                f, getattr(p, f), getattr(j, f))
