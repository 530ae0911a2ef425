"""Generate examples/demo_torch.ipynb: the notebook form of the PyTorch
port's single-image demo (``pcdms_tpu_torch/cli/demo.py``), with the cells
of ``examples/make_demo_notebook.py`` (load the monolithic checkpoint ->
build the [source | black] canvas and the pose render -> DINOv2 features ->
50-step DDIM stage-2 sampling -> show the right half) calling the port.

The notebook is a committed artifact; re-run this generator after editing
the cell sources below. The generator needs ``nbformat``; the notebook's
code cells do not (they import only the port, numpy, torch, PIL, and
matplotlib where it is installed), so they also run where nbformat is
absent, read with ``json``. ``PCDMS_DEMO_TINY=1`` shrinks every model and
``PCDMS_DEMO_DEVICE=cpu`` runs on the CPU (the default is the CUDA card).

    python examples/make_demo_notebook_torch.py
"""

MD_INTRO = """\
# PCDMs — single-image pose-transfer demo (PyTorch / CUDA)

The notebook form of the reference's `pcdms_kaggle_demo.ipynb`
(the simplified stage-2-only release) on the PyTorch port
`pcdms_tpu_torch`: one monolithic `pcdms_ckpt.pt` (9-channel inpainting
UNet without class embedding + pose / image projections), DDIM sampling on
a `[source | black]` 512x1024 canvas conditioned on a rendered target pose
skeleton and DINOv2-giant source features, on a CUDA card.

Without checkpoints on disk the notebook draws random weights instead
(`PCDMS_DEMO_TINY=1` also shrinks every model), so the whole path runs
anywhere: the output is noise, but every stage executes for real.
"""

CELL_SETUP = """\
import os

import numpy as np
import torch

# --- knobs -----------------------------------------------------------
TINY = os.environ.get("PCDMS_DEMO_TINY", "0") == "1"  # CPU smoke
DEVICE = os.environ.get("PCDMS_DEMO_DEVICE", "cuda")  # "cpu" to run there
SIZE = 64 if TINY else 512
STEPS = 2 if TINY else 50
GUIDANCE = 2.0
SEED = 42

SOURCE = "person.png"           # source person image
TARGET_POSE = "target_pose.txt" # 18-kpt normalized .txt OR skeleton img
SOURCE_POSE = None              # optional; None -> black left pose half
CKPT = "pcdms_ckpt.pt"          # monolithic stage-2 release checkpoint
SD = "ckpts/sd21"               # SD-2.1 dir (VAE weights)
DINOV2 = "ckpts/dinov2-giant"

from pcdms_tpu_torch.utils.device import resolve_device

device = resolve_device(DEVICE)
print(device, torch.cuda.get_device_name(device)
      if device.type == "cuda" else "")
"""

MD_WEIGHTS = """\
## Weights

With the released `pcdms_ckpt.pt` + SD-2.1 + DINOv2-giant on disk this
loads them through `pcdms_tpu_torch.compat.load`; otherwise it draws the
same architectures' weights from the seed, so the notebook stays
executable end to end. Sampling runs in bf16.
"""

CELL_WEIGHTS = """\
from types import SimpleNamespace

from pcdms_tpu_torch.cli.demo import build_models, model_configs

have_ckpts = not TINY and all(os.path.exists(p) for p in (CKPT, SD, DINOV2))
if not have_ckpts:
    print("checkpoints not found -> random weights (smoke mode)")
cfg = model_configs(TINY)
models, dino = build_models(
    SimpleNamespace(random_init=not have_ckpts, seed=SEED, ckpt=CKPT,
                    sd=SD, dinov2=DINOV2), cfg, device)
models = {k: m.to(torch.bfloat16) for k, m in models.items()}
dino = dino.to(torch.bfloat16)
"""

MD_INPUTS = """\
## Inputs

The stage-2 conditioning protocol (reference
`pcdms_kaggle_demo.ipynb` / `PCDMs_pipeline.py`): a `[source | black]`
image canvas, a `[source-pose | target-pose]` skeleton canvas rendered
with the OpenPose limb palette the model was trained on, and the DINOv2
input of the source crop.
"""

CELL_INPUTS = """\
from pcdms_tpu_torch.cli.demo import demo_inputs

if not os.path.exists(SOURCE):      # smoke mode: synthesize the inputs
    print("no source image -> synthetic gradient + standing pose")
    from PIL import Image
    g = np.linspace(0, 255, SIZE, dtype=np.uint8)
    Image.fromarray(np.stack([np.tile(g, (SIZE, 1))] * 3, -1)).save("person.png")
    SOURCE = "person.png"
    kpts = np.array([[.5,.1],[.5,.22],[.38,.22],[.34,.4],[.32,.55],
                     [.62,.22],[.66,.4],[.68,.55],[.44,.52],[.43,.72],
                     [.42,.9],[.56,.52],[.57,.72],[.58,.9],[.47,.08],
                     [.53,.08],[.44,.1],[.56,.1]], np.float32)
    np.savetxt("target_pose.txt", kpts)   # one "x y" line per keypoint
    TARGET_POSE = "target_pose.txt"

canvas, pose_canvas, dino_pixels = demo_inputs(
    SOURCE, SOURCE_POSE, TARGET_POSE, SIZE)
print("canvas", canvas.shape, "pose", pose_canvas.shape,
      "dino input", dino_pixels.shape)
"""

CELL_SHOW_INPUTS = """\
try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:                 # no plotting here: skip the figures
    plt = None

if plt is not None:
    fig, axes = plt.subplots(1, 2, figsize=(10, 3))
    axes[0].imshow((canvas + 1) / 2); axes[0].set_title("image canvas")
    axes[1].imshow((pose_canvas + 1) / 2); axes[1].set_title("pose canvas")
    for ax in axes:
        ax.axis("off")
    plt.show()
"""

MD_SAMPLE = """\
## Sample

DINOv2 features of the source, VAE-encode of the canvas, 50-step DDIM
with CFG over the 9-channel inpainting UNet (the attention through the
port's CUDA flash kernels on the card), VAE-decode.
`encoder_cache_interval=2` switches on encoder propagation (approximate);
the default is the exact sampler.
"""

CELL_SAMPLE = """\
from pcdms_tpu_torch.cli.demo import generate

images = generate(
    models, dino, canvas, pose_canvas, dino_pixels, steps=STEPS,
    guidance_scale=GUIDANCE, encoder_cache_interval=1,
    generator=torch.Generator(device=device).manual_seed(SEED),
    device=device)
result = images[0, :, SIZE:, :].float().cpu().numpy()  # right half
assert np.isfinite(result).all()
print("generated", result.shape)
"""

CELL_SHOW_RESULT = """\
from PIL import Image

out8 = np.rint((np.clip(result, -1, 1) + 1) * 127.5).astype(np.uint8)
Image.fromarray(out8).save("result.png")
if plt is not None:
    plt.figure(figsize=(4, 4))
    plt.imshow(out8); plt.axis("off"); plt.title("generated target")
    plt.show()
print("wrote result.png")
"""

CELLS = [
    ("markdown", MD_INTRO), ("code", CELL_SETUP),
    ("markdown", MD_WEIGHTS), ("code", CELL_WEIGHTS),
    ("markdown", MD_INPUTS), ("code", CELL_INPUTS),
    ("code", CELL_SHOW_INPUTS), ("markdown", MD_SAMPLE),
    ("code", CELL_SAMPLE), ("code", CELL_SHOW_RESULT),
]


def build():
    import nbformat as nbf
    nb = nbf.v4.new_notebook()
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3", "language": "python", "name": "python3",
    }
    make = {"markdown": nbf.v4.new_markdown_cell,
            "code": nbf.v4.new_code_cell}
    nb.cells = [make[kind](src) for kind, src in CELLS]
    # deterministic cell ids -> stable diffs across regenerations
    for i, c in enumerate(nb.cells):
        c["id"] = f"cell-{i}"
    return nb


if __name__ == "__main__":
    import os.path

    import nbformat
    path = os.path.join(os.path.dirname(__file__), "demo_torch.ipynb")
    with open(path, "w") as f:
        nbformat.write(build(), f)
    print(f"wrote {path}")
