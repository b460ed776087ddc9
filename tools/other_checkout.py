"""Load a module of another checkout of the repo beside this tree's, so
that a tool can time two versions of a function in one process."""
import importlib.util
import os


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
