from setuptools import setup, find_packages

setup(
    name="hetu_tpu",
    version="0.1.0",
    description=("TPU-native distributed deep-learning framework with the "
                 "capabilities of Hetu (dataflow graph API, DP/TP/PP/EP/CP "
                 "parallelism over JAX meshes, parameter server with "
                 "HET-style embedding cache, MoE, auto-parallel planner)"),
    packages=find_packages(include=["hetu_tpu", "hetu_tpu.*",
                                    "hetu_tpu_torch", "hetu_tpu_torch.*"]),
    package_data={"hetu_tpu.native": ["*.so", "*.cpp"],
                  "hetu_tpu_torch.kernels": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    # the PyTorch/CUDA port (hetu_tpu_torch) needs torch, not jax:
    # pip install .[torch]
    extras_require={"torch": ["torch", "numpy"]},
    entry_points={"console_scripts":
                  ["heturun=hetu_tpu.launcher:main"]},
)
