"""Dataset conversion CLI (counterpart of scripts/convert_librispeech.py;
reference: datasets/convert_librispeech.py).

Builds SampleStore .npz files from a LibriSpeech-style manifest and its wav
or FLAC files: the waveform store (the reference's ``{name}-npy.pt``) and,
with --features, the precomputed-features store (``{name}-input.pt``),
featurized on the card unless --device cpu:

  python -m rnnt_inference_tpu_torch.tools.convert_librispeech \\
      --data_dir LibriSpeech/dev-clean-wav --manifest dev-clean-wav.json \\
      --output dev-clean.npz --features

  # a raw LibriSpeech subset directory (*/*/*.trans.txt and .flac files)
  python -m rnnt_inference_tpu_torch.tools.convert_librispeech \\
      --input_dir LibriSpeech/dev-clean --output dev-clean.npz

  # calibration subset (reference: configs/calibration_files.txt)
  python -m rnnt_inference_tpu_torch.tools.convert_librispeech --data_dir ... \\
      --manifest ... --output train-calib.npz --calib_list configs/calibration_files.txt
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def build_manifest_from_dir(input_dir: str, out_path: str) -> int:
    """Scan a raw LibriSpeech subset directory into a manifest JSON:
    ``<spk>/<chap>/<spk>-<chap>.trans.txt`` lines of ``<utt-id>
    TRANSCRIPT``, one ``<utt-id>.flac`` each; durations from each file's
    STREAMINFO header, with no frame decoded."""
    from rnnt_inference_tpu_torch.data.flac import flac_stream_info

    entries = []
    for txt in sorted(glob.glob(os.path.join(input_dir, "**", "*.trans.txt"), recursive=True)):
        chap_dir = os.path.dirname(txt)
        with open(txt) as f:
            for line in f:
                utt_id, _, transcript = line.strip().partition(" ")
                if not utt_id:
                    continue
                flac_path = os.path.join(chap_dir, utt_id + ".flac")
                total, sr = flac_stream_info(flac_path)
                entries.append({"audio_filepath": os.path.relpath(flac_path, input_dir),
                                "duration": total / sr, "transcript": transcript})
    with open(out_path, "w") as f:
        json.dump(entries, f)
    return len(entries)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("convert_librispeech")
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--input_dir", type=str, default=None,
                   help="raw LibriSpeech subset dir: scans */*/*.trans.txt into a manifest "
                        "first, then converts")
    p.add_argument("--manifest", type=str, default=None)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--max_duration", type=float, default=15.0)
    p.add_argument("--calib_list", type=str, default=None,
                   help="only convert the utterances listed in this file (matched by basename)")
    p.add_argument("--features", action="store_true",
                   help="also write the precomputed-features store <output stem>-input.npz")
    p.add_argument("-s", "--speed", type=float, nargs="*", default=None,
                   help="speed perturbation ratios (each ratio s adds a {stem}-{s} copy)")
    p.add_argument("--workers", type=int, default=0, help="decode worker processes")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where --features featurizes")
    args = p.parse_args(argv)

    from rnnt_inference_tpu_torch.data.dataset import compute_features_store, convert_librispeech

    stem = args.output[:-4] if args.output.endswith(".npz") else args.output
    if args.input_dir:
        manifest_path = stem + ".manifest.json"
        n = build_manifest_from_dir(args.input_dir, manifest_path)
        print(f"scanned {args.input_dir}: {n} utterances -> {manifest_path}")
        args.manifest = manifest_path
        args.data_dir = args.data_dir or args.input_dir
    if not args.manifest:
        p.error("need --manifest or --input_dir")

    store = convert_librispeech(args.data_dir, args.manifest, args.output, args.max_duration,
                                file_list=args.calib_list, speeds=args.speed,
                                workers=args.workers)
    print(f"wrote {args.output}: {len(store)} utterances, "
          f"{store.audio_seconds:.0f} audio-seconds")
    if args.features:
        fpath = stem + "-input.npz"
        fstore = compute_features_store(store, device=args.device)
        fstore.save(fpath)
        print(f"wrote {fpath}: precomputed features "
              f"({sum(s.shape[0] for s in fstore.samples)} frames)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
