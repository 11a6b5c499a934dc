"""Build for horovod_tpu, including the native core extension.

The reference builds its C++ core per-framework via a CMake superbuild
(reference: setup.py + CMakeLists.txt, SURVEY.md §2.1 "Build system").  On
TPU there is exactly one framework ABI (CPython), so a single setuptools
Extension suffices: ``horovod_tpu.native._hvd_core`` holds the control-plane
hot paths (fusion planner, response cache, timeline writer, stall tracker).

Build in place with::

    python setup.py build_ext --inplace

or let ``horovod_tpu.native.loader`` build it on first use.
"""

import os

from setuptools import Extension, find_packages, setup

ext = Extension(
    "horovod_tpu.native._hvd_core",
    sources=["horovod_tpu/native/core.cpp"],
    language="c++",
    extra_compile_args=["-std=c++17", "-O2", "-fvisibility=hidden"],
)

# Feature-flag matrix (reference: HOROVOD_WITH_*/HOROVOD_WITHOUT_* in
# the reference's setup.py): one flag suffices here — frameworks are
# pure-Python adapters over the shared engine, so only the native core
# is a build-time choice.  `hvdrun --check-build` prints what was built.
exts = [] if os.environ.get("HOROVOD_WITHOUT_NATIVE_CORE") == "1" else [ext]

setup(
    name="horovod_tpu",
    version="0.1.0",
    description="TPU-native distributed training framework "
                "(capability rebuild of Horovod)",
    packages=find_packages(exclude=("tests", "tests.*")),
    # native sources ride the wheel: the TF XLA op bridge (and the
    # pure-python-install fallback of the core) compile on demand from
    # the installed tree
    package_data={"horovod_tpu.native": ["*.cc", "*.cpp"],
                  # the port's CUDA sources, compiled by nvcc at first use
                  "horovod_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  # the port's native core and TF op bridge, compiled by
                  # g++ at first use
                  "horovod_tpu_torch.native": ["*.cpp", "*.cc"],
                  "horovod_tpu_torch.analysis": ["baseline.json"]},
    ext_modules=exts,
    entry_points={
        "console_scripts": [
            "hvdrun = horovod_tpu.runner.launch:main",
            "hvdrun-torch = horovod_tpu_torch.runner.launch:main",
        ],
    },
    python_requires=">=3.10",
)
