"""Score an accuracy log against a manifest: corpus WER (counterpart of the
repository's eval_accuracy.py; same flags, same printed line, same
hypotheses.log).

    python -m rnnt_inference_tpu_torch.tools.eval_accuracy \\
        --log_path out/accuracy_log.json --manifest_path dev-clean.json \\
        [--max_duration 15.0] [--hypotheses_out hypotheses.log]

Reads [{qsl_idx, data: <hex int32 tokens>}] (the accuracy log ``main
--accuracy`` writes), decodes it to text in qsl_idx order, scores the corpus
WER against the manifest's transcripts of utterances up to max_duration
seconds, and writes one ``idx::text`` line per hypothesis (what
scripts/cmp_res.py reads).  The scoring is runtime/harness.py's
``eval_accuracy_log``, the in-run scorer.  It reads files and runs no
kernel, so it needs no card.
"""

from __future__ import annotations

import argparse
import sys

from rnnt_inference_tpu_torch.data.manifest import Manifest
from rnnt_inference_tpu_torch.runtime.harness import accuracy_log_hypotheses
from rnnt_inference_tpu_torch.utils.wer import word_error_rate


def main(argv=None) -> float:
    """Prints the WER line and writes the hypotheses; returns the WER."""
    p = argparse.ArgumentParser("eval_accuracy")
    p.add_argument("--log_path", type=str, required=True)
    p.add_argument("--manifest_path", type=str, required=True)
    p.add_argument("--max_duration", type=float, default=15.0)
    p.add_argument("--hypotheses_out", type=str, default="hypotheses.log")
    args = p.parse_args(argv)

    references = Manifest([args.manifest_path], max_duration=args.max_duration).transcripts
    hypotheses = accuracy_log_hypotheses(args.log_path)
    wer, _, _ = word_error_rate(hypotheses, references)
    print(f"Word Error Rate: {wer * 100}%, accuracy={(1 - wer) * 100}%")
    with open(args.hypotheses_out, "w") as f:
        for i, h in enumerate(hypotheses):
            f.write(f"{i}::{h}\n")
    return wer


if __name__ == "__main__":
    main(sys.argv[1:])
