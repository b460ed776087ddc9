"""Load a module of another checkout of the repo beside this tree's, so
that a tool can time two versions of a function in one process."""
import contextlib
import importlib.util
import os
import sys

BUILD_MOD = "av1dec_tpu_torch.ops.kernels.cuda_build"


def load(root, module, tag):
    """Module `module` (dotted, e.g. "av1dec_tpu_torch.ops.kernels.lr") of
    the checkout at `root`, run under its own name `<tag>_<last part>`;
    its imports of the package still resolve to this tree's."""
    path = os.path.join(root, *module.split(".")) + ".py"
    name = f"{tag}_{module.rsplit('.', 1)[-1]}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def kernels_of(build):
    """`build` (a checkout's `cuda_build` module) in place of this tree's
    while the block runs, for the import inside a kernel wrapper, so that
    the wrapper loads its own checkout's kernels."""
    real = sys.modules[BUILD_MOD]
    sys.modules[BUILD_MOD] = build
    try:
        yield
    finally:
        sys.modules[BUILD_MOD] = real
