"""The benchmark's models: one module per architecture, which the harness
reaches through the ``"model"`` key of a configuration file.

A configuration that says ``"model": "<name>"`` is served by
benchmark/models/<name>.py of the cell's checkout, loaded by file path
(``load``) and kept on the cell as ``cell.model``.  Everything that depends
on the architecture lives there; the drivers, the check and the readers
call only these functions of it (``config`` is the configuration file's
dict):

  random_weights(config, device) -> dict
      float32 weights drawn on ``device`` from the configuration's weight
      seed, in the form the reference takes.
  apply_emission(weights, emission, config) -> dict
      the weights with the cell's emission model (the cell file's
      "emission") applied.
  program(config, weights, device, max_symbols_per_step)
      -> (served weights, params, featurizer config)
      the program's objects made from the float32 weights: the weights it
      serves (any calibration and quantization done here), its model
      parameters at the cap and the featurizer config its runners take.
  reference(config, weights, device, lower=False)
      the plain reference built from the file the configuration's
      "reference" key names: an object with ``encode(wavs)`` (the
      encoder's output of each waveform), ``lattice(f, tokens)`` (the
      joint's logits at every node of an answer's alignment lattice),
      ``greedy(f, cap, max_len)`` (its own greedy decode), ``blank`` (the
      blank label) and ``max_len`` (the longest answer the program keeps).
      lower=True: every precision one step down (the control).
  work(config, params, featurizer, lens, tokens, reps) -> dict
      the work ``reps`` reps of utterances of ``lens`` samples served as
      ``tokens`` need: "frames" (feature frames), "post_frames" (the
      encoder's output frames, which the decode walks) and "symbols".
  least(config, work) -> seconds
      the least time of the model's products for ``work``, each at its
      precision's peak (benchmark/roofline.py): offline.mfu's numerator.
  decode_costs(config) -> dict
      kernel B's costs (benchmark/roofline.py kernel_b): "iteration_ops",
      the operations of one lane-iteration; "weight_bytes", the weights it
      reads a launch; "frame_bytes", the encoder projection it reads a
      frame; "precision" of its products.
  recording()
      a context manager yielding {kernel: [shape, ...]}: the shapes of the
      calls into the program's kernels while it is open (the traced reps),
      which the roofline readers count.
  emission_probe(config, weights, wav, lens, device)
      for benchmark/calibrate_emission.py: the program's encoder run once
      over the batch ``wav`` (N, samples) of ``lens`` on the program form
      of ``weights``; returns ``symbols(weights, cap) -> (symbols, frames)``,
      per utterance, of the program's greedy decode with the prediction
      net and joint of other weights.

A second architecture is added as files alone: its module here, its
reference under benchmark/reference/, its configuration, traffic, cell and
metric files, and its entries in BENCHMARK.json.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType

INTERFACE = ("random_weights", "apply_emission", "program", "reference", "work", "least",
             "decode_costs", "recording", "emission_probe")


def from_file(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` loaded as a module named ``name``, which
    stands in sys.modules only while it runs (a dataclass looks its module
    up there), so a module imported under that name is left as it was."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    before = sys.modules.get(name)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        if before is None:
            del sys.modules[name]
        else:
            sys.modules[name] = before
    return mod


def load(name: str, repo: Path) -> ModuleType:
    """benchmark/models/<name>.py of the checkout ``repo``, loaded by file
    path; it has to define every function of the interface."""
    path = Path(repo) / "benchmark" / "models" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no model module {path}")
    mod = from_file(path, f"benchmark.models.{name}")
    missing = [f for f in INTERFACE if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"model module {path} lacks {missing}")
    return mod
