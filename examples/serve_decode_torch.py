"""Serving example on the PyTorch port: batched prefill + decode across
several architectures (reduced variants) through the port's kernels:
a dense model, a hybrid and a recurrent one, and Whisper's
encoder-decoder, on the card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import serve

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda",
                    help="where the models run (default: cuda)")
args = parser.parse_args()

for arch in ("smollm-360m", "hymba-1.5b", "xlstm-125m", "whisper-large-v3"):
    serve(arch, batch=2, prompt_len=24, new_tokens=8, device=args.device)
