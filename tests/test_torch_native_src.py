"""The port builds its native C++ from its own copies of the sources
(hnsw_tpu_torch/native/src/), and no module of the port reads a file of the
JAX package. No socket, no subprocess: the build itself is tested in
test_torch_native_services.py (`slow`)."""

import ast
import filecmp
import os

import pytest

from hnsw_tpu_torch import native
from hnsw_tpu_torch.buildutil import PKG_DIR

ROOT = os.path.dirname(PKG_DIR)
REFERENCE_NATIVE = os.path.join(ROOT, "hnsw_tpu", "native")

# calls that build a path or open, list, load or run a file: a string that
# names the JAX package must not reach one
_PATH_CALLS = {
    "join", "open", "Path", "PurePath", "glob", "iglob", "listdir", "scandir", "walk",
    "exists", "isfile", "isdir", "abspath", "realpath", "CDLL", "LoadLibrary", "run",
    "Popen", "check_call", "check_output", "copy", "copyfile", "copytree", "read_text",
    "read_bytes", "build_if_stale", "load", "fromfile", "loadtxt", "import_module",
}


def _names_reference(value: str) -> bool:
    parts = value.replace("\\", "/").split("/")
    return "hnsw_tpu" in parts


def _port_modules() -> list[str]:
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, files in os.walk(PKG_DIR):
        dirnames[:] = [d for d in dirnames if d not in ("_build", "__pycache__")]
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _reads_reference(path: str) -> list[str]:
    """`file:line` of each call in `path` that builds a path, or opens, lists,
    loads or runs a file, with a string naming the JAX package among its
    arguments (a docstring or message that names a file of it is fine)."""
    tree = ast.parse(open(path).read(), path)
    hits = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
        if name not in _PATH_CALLS:
            continue
        for arg in [*node.args, *(k.value for k in node.keywords)]:
            for sub in ast.walk(arg):
                if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                        and _names_reference(sub.value)):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{node.lineno}")
    return hits


def test_no_port_module_reads_the_reference_package():
    modules = _port_modules()
    assert os.path.join(PKG_DIR, "native", "__init__.py") in modules
    hits = [h for m in modules for h in _reads_reference(m)]
    assert hits == []


def test_the_scan_finds_a_path_into_the_reference(tmp_path):
    """The scan above flags the form the native build once used."""
    bad = tmp_path / "bad.py"
    bad.write_text('import os\nD = os.path.join(os.path.dirname(__file__), "hnsw_tpu", "native")\n'
                   'open("hnsw_tpu/native/builder.cpp")\n')
    assert len(_reads_reference(str(bad))) == 2


def test_native_sources_lie_in_the_port():
    srcs = [native.BUILDER_SRC, native.VECSTORE_SRC,
            *native.binary_sources("storage_main"), *native.binary_sources("query_main")]
    src_dir = os.path.realpath(os.path.join(PKG_DIR, "native", "src"))
    for src in srcs:
        assert os.path.isfile(src), src
        assert os.path.dirname(os.path.realpath(src)) == src_dir, src
    assert os.path.basename(native.binary_sources("query_main")[0]) == "query_main.cpp"


@pytest.mark.parametrize("name", ["builder.cpp", "vecstore.cpp", "httpkit.h",
                                  "storage_main.cpp"])
def test_unchanged_copies_are_byte_equal(name):
    ours = os.path.join(PKG_DIR, "native", "src", name)
    assert filecmp.cmp(ours, os.path.join(REFERENCE_NATIVE, name), shallow=False)
