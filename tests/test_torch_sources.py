"""The port's C entry points against their ctypes bindings, on the CPU.

Every ``_build.function(lib, name, argtypes)`` call in
``vfdepth_tpu_torch/ops/`` must name an ``extern "C" int name(...)`` of
``csrc/<lib>.cu`` whose parameters match ``argtypes`` in number and kind
(a pointer is ``c_void_p``, ``int64_t`` is ``c_int64``, ``int`` is
``c_int``, ``float`` is ``c_float``), and every entry point of ``csrc/``
must be bound somewhere. A renamed or re-signatured entry point then fails
here, not only on the card, where ctypes would pass its arguments as the
binding says and the kernel would read them as the source says.

The bindings are read from the modules' source: a call's entry name may be
a string, a conditional of strings, a sum of those, or a local name
assigned such a value (each assignment a case, with the names it binds
alongside, as ``fn_name, extra = ..., (...)``); its argument types are
evaluated with the module's globals and those names.
"""
import ast
import builtins
import ctypes
import importlib
import re
from pathlib import Path

import pytest
from helpers_torch_threads import port_threads  # noqa: F401

PKG = Path(__file__).resolve().parent.parent / "vfdepth_tpu_torch"
OPS, CSRC = PKG / "ops", PKG / "csrc"

_C_KINDS = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
            "float": ctypes.c_float}


def _strings(node, env):
    """Every string value the expression ``node`` can take."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, ast.IfExp):
        return _strings(node.body, env) | _strings(node.orelse, env)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return {a + b for a in _strings(node.left, env)
                for b in _strings(node.right, env)}
    if isinstance(node, ast.Name) and node.id in env:
        return _strings(env[node.id], env)
    raise ValueError(f"cannot read an entry name from {ast.dump(node)}")


class _Locals(dict):
    """A function's locals for evaluating argument types: the names bound
    by the case's assignment, then the module's globals and the builtins,
    0 for any other name (a local the types do not depend on)."""

    def __init__(self, module, bound=()):
        super().__init__(bound)
        self.module = module

    def __missing__(self, key):
        for scope in (vars(self.module), vars(builtins)):
            if key in scope:
                return scope[key]
        return 0


def _cases(func):
    """(local name -> value node) environments of ``func``: one for each
    assignment in it, with the names it binds (a tuple assignment binds
    several at once)."""
    assigns = []
    for node in ast.walk(func):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target, value = node.targets[0], node.value
        if isinstance(target, ast.Name):
            assigns.append({target.id: value})
        elif (isinstance(target, ast.Tuple) and isinstance(value, ast.Tuple)
              and len(target.elts) == len(value.elts)
              and all(isinstance(t, ast.Name) for t in target.elts)):
            assigns.append({t.id: v for t, v in zip(target.elts,
                                                    value.elts)})
    return assigns


def _bindings():
    """[(module, lib, entry name, argument types)] of every binding call."""
    found = []
    for path in sorted(OPS.glob("*.py")):
        module = importlib.import_module(f"vfdepth_tpu_torch.ops.{path.stem}")
        tree = ast.parse(path.read_text())
        for func in ast.walk(tree):
            if not isinstance(func, ast.FunctionDef):
                continue
            for call in ast.walk(func):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "function"
                        and isinstance(call.func.value, ast.Name)
                        and call.func.value.id == "_build"):
                    continue
                lib = ast.literal_eval(call.args[0])
                name_node, types_node = call.args[1], call.args[2]
                envs = [{}]
                if isinstance(name_node, ast.Name):
                    envs = [e for e in _cases(func) if name_node.id in e]
                expr = compile(ast.Expression(types_node), str(path), "eval")
                for env in envs:
                    local = _Locals(module, {
                        k: eval(compile(ast.Expression(v), str(path), "eval"),
                                {}, _Locals(module))
                        for k, v in env.items()
                        if k != getattr(name_node, "id", None)})
                    argtypes = eval(expr, {}, local)
                    for name in sorted(_strings(name_node, env)):
                        found.append((path.stem, lib, name, list(argtypes)))
    return found


def _entries():
    """{(lib, entry name): [parameter declarations]} of every extern "C"
    function in csrc/*.cu."""
    entries = {}
    for path in sorted(CSRC.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)',
                             text):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            entries[(path.stem, m.group(1))] = [p for p in params if p]
    return entries


BINDINGS = _bindings()
ENTRIES = _entries()


def _kind(decl: str):
    """The ctypes type a C parameter declaration is passed as."""
    if "*" in decl:
        return ctypes.c_void_p
    base = decl.replace("const ", "").split()[0]
    return _C_KINDS[base]


def test_the_sources_have_bindings_and_entry_points():
    # the parsing above found what the port has: 5 sources, 17 entries
    assert len({lib for lib, _ in ENTRIES}) == 5
    assert len(ENTRIES) >= 17 and len(BINDINGS) >= 17


@pytest.mark.parametrize("module,lib,name,argtypes", BINDINGS,
                         ids=[f"{b[0]}-{b[2]}" for b in BINDINGS])
def test_binding_matches_its_entry_point(module, lib, name, argtypes):
    assert (CSRC / f"{lib}.cu").exists(), f"{module}: no csrc/{lib}.cu"
    params = ENTRIES.get((lib, name))
    assert params is not None, (f"{module} binds {name}, which csrc/{lib}.cu "
                                f"does not define as extern \"C\" int")
    assert len(params) == len(argtypes), (
        f"{name}: {len(params)} parameters in csrc/{lib}.cu, {len(argtypes)} "
        f"argument types in ops/{module}.py")
    for i, (decl, t) in enumerate(zip(params, argtypes)):
        assert _kind(decl) is t, (f"{name} parameter {i} `{decl}` is passed "
                                  f"as {t.__name__}")


@pytest.mark.parametrize("lib,name", sorted(ENTRIES),
                         ids=[n for _, n in sorted(ENTRIES)])
def test_entry_point_is_bound(lib, name):
    assert any(b[1] == lib and b[2] == name for b in BINDINGS), (
        f"csrc/{lib}.cu defines {name}, which no wrapper in ops/ binds")
