"""AST rules RT001-RT005: the port's own disciplines, machine-checked.

Port of ``repro.analysis.rules``.  Each rule is grounded in a rule of the
port or a fault it had; the checker is pure stdlib (``ast`` only), so the
lint layer imports neither torch nor jax.

Scopes, by path (``/`` separated, matched anywhere in the path):

* the port's program files: ``repro_torch/``, ``chip_smoke.py`` and
  ``tools/`` (RT001, RT002, RT004);
* its device-program modules, whose loops drive the card:
  ``repro_torch/sim/{torch_sim,device_timeline,batch_engine,cluster}.py``,
  ``repro_torch/serve/``, ``repro_torch/models/``, ``repro_torch/train/``
  (RT005);
* every file (RT003).

Name resolution follows import aliases (``import torch as T``), so the
rules match the canonical dotted path, not the surface spelling.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    # The stripped source line, used for line-number-independent baseline
    # hashes (see repro_torch.analysis.baseline).
    source_line: str = ""

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: {self.rule} {self.message}"


RULES: dict[str, str] = {
    "RT001": (
        "a module of the port imports jax, jaxlib or repro: the port stands "
        "alone (tests/test_torch_isolation.py checks it at run time) — keep "
        "its own copy of what it needs"
    ),
    "RT002": (
        "a device chosen by availability outside repro_torch/device.py "
        "(torch.cuda.is_available() in a condition that picks a device, or "
        "'cpu' as a public function's default): the card is the default and "
        "the CPU runs only on request, with no quiet fallback — take "
        "device=None and call device.resolve_device"
    ),
    "RT003": (
        "a try whose body calls a hand-written kernel (a *_cuda function or "
        "build.library) and whose handler goes on without re-raising: a quiet "
        "fallback to the plain version — let the kernel's error raise"
    ),
    "RT004": (
        "hard-coded torch.float32 (or .float()) inside a function that takes "
        "a dtype parameter: it truncates the float64 path, as the float64 "
        "retry ladders' float32 factor once did — derive the dtype from the "
        "parameter"
    ),
    "RT005": (
        "host read-back (.item(), .tolist(), .cpu(), .numpy(), "
        "torch.cuda.synchronize()) inside a loop of a device-program module: "
        "a device round trip every iteration — keep the value on the card, "
        "or read it once after the loop"
    ),
}

_FORBIDDEN_IMPORTS = ("jax", "jaxlib", "repro")
_PORT_PARTS = ("/repro_torch/", "/tools/")
_DEVICE_POLICY = "/repro_torch/device.py"
_DEVICE_PROGRAMS = (
    "/repro_torch/sim/torch_sim.py",
    "/repro_torch/sim/device_timeline.py",
    "/repro_torch/sim/batch_engine.py",
    "/repro_torch/sim/cluster.py",
    "/repro_torch/serve/",
    "/repro_torch/models/",
    "/repro_torch/train/",
)
_READBACK_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC = "torch.cuda.synchronize"
_AVAILABLE = "torch.cuda.is_available"
_F32 = "torch.float32"


def _is_dtype_param(name: str) -> bool:
    return name == "dtype" or name.endswith("_dtype")


def _import_aliases(tree: ast.Module) -> dict[str, str]:
    """Map local names bound by imports of torch to their dotted paths."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                if al.name.split(".")[0] == "torch":
                    aliases[al.asname or "torch"] = al.name if al.asname else "torch"
        elif isinstance(node, ast.ImportFrom) and node.module and node.module.split(".")[0] == "torch":
            for al in node.names:
                aliases[al.asname or al.name] = f"{node.module}.{al.name}"
    return aliases


def _forbidden_module(name: str) -> bool:
    return any(name == root or name.startswith(root + ".") for root in _FORBIDDEN_IMPORTS)


class _Checker:
    def __init__(self, tree: ast.Module, path: str, source_lines: list[str]):
        self.tree = tree
        self.path = path
        self.lines = source_lines
        self.aliases = _import_aliases(tree)
        self.findings: list[Finding] = []
        where = "/" + path.replace("\\", "/")
        self.port = any(p in where for p in _PORT_PARTS) or where.endswith("/chip_smoke.py")
        self.policy_module = where.endswith(_DEVICE_POLICY)
        self.in_package = "/repro_torch/" in where
        self.device_program = any(p in where for p in _DEVICE_PROGRAMS)
        # Walk state.
        self._loop_depth = 0
        self._dtype_param: str | None = None  # active dtype parameter name
        self._rt004_exempt = 0  # inside a selection on the dtype parameter, a comparison or a default

    # ---- helpers ---------------------------------------------------------

    def _dotted(self, node: ast.AST) -> str | None:
        """Canonical dotted path for a Name/Attribute chain, else None."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.aliases.get(node.id, node.id))
        return ".".join(reversed(parts))

    def _emit(self, rule: str, node: ast.AST, message: str):
        line = getattr(node, "lineno", 1)
        src = self.lines[line - 1].strip() if 0 < line <= len(self.lines) else ""
        self.findings.append(Finding(rule, self.path, line, getattr(node, "col_offset", 0), message, src))

    def _calls(self, node: ast.AST, dotted: str) -> bool:
        return any(isinstance(sub, ast.Call) and self._dotted(sub.func) == dotted for sub in ast.walk(node))

    # ---- main walk -------------------------------------------------------

    def run(self) -> list[Finding]:
        for stmt in self.tree.body:
            self._visit(stmt)
        return self.findings

    def _visit(self, node: ast.AST):
        method = getattr(self, f"_visit_{type(node).__name__}", None)
        if method is not None:
            method(node)
        else:
            self._generic(node)

    def _generic(self, node: ast.AST):
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    def _visit_all(self, nodes):
        for n in nodes:
            self._visit(n)

    # -- imports (RT001) --

    def _visit_Import(self, node: ast.Import):
        if self.port:
            for al in node.names:
                if _forbidden_module(al.name):
                    self._emit("RT001", node, f"imports {al.name}: the port imports neither jax nor repro")

    def _visit_ImportFrom(self, node: ast.ImportFrom):
        if self.port and node.level == 0 and node.module and _forbidden_module(node.module):
            self._emit("RT001", node, f"imports from {node.module}: the port imports neither jax nor repro")

    # -- function scopes --

    def _visit_FunctionDef(self, node):
        self._enter_function(node)

    def _visit_AsyncFunctionDef(self, node):
        self._enter_function(node)

    def _enter_function(self, node):
        self._visit_all(node.decorator_list)
        defaults = list(node.args.defaults) + [d for d in node.args.kw_defaults if d is not None]
        self._check_cpu_defaults(node, defaults)
        self._rt004_exempt += 1  # a dtype=torch.float32 default is the sanctioned spelling
        self._visit_all(defaults)
        self._rt004_exempt -= 1
        all_args = node.args.posonlyargs + node.args.args + node.args.kwonlyargs
        param = next((a.arg for a in all_args if _is_dtype_param(a.arg)), None)
        prev_param, prev_depth = self._dtype_param, self._loop_depth
        if param is not None:
            self._dtype_param = param
        self._loop_depth = 0  # the body runs when called, not in the enclosing loop
        self._visit_all(node.body)
        self._dtype_param, self._loop_depth = prev_param, prev_depth

    def _visit_Lambda(self, node: ast.Lambda):
        self._rt004_exempt += 1
        self._visit_all(list(node.args.defaults) + [d for d in node.args.kw_defaults if d is not None])
        self._rt004_exempt -= 1
        prev_depth, self._loop_depth = self._loop_depth, 0
        self._visit(node.body)
        self._loop_depth = prev_depth

    # -- RT002 --

    def _check_cpu_defaults(self, node, defaults):
        if not self.in_package or self.policy_module:
            return
        public = not node.name.startswith("_") or (node.name.startswith("__") and node.name.endswith("__"))
        if not public:
            return
        for d in defaults:
            if (isinstance(d, ast.Constant) and d.value == "cpu") or (
                isinstance(d, ast.Call) and self._dotted(d.func) == "torch.device"
                and any(isinstance(a, ast.Constant) and a.value == "cpu" for a in d.args)
            ):
                self._emit("RT002", d, f"'cpu' default of public function {node.name}: default to the card "
                                       "(device=None) and run on the CPU only when asked")

    def _picks_device(self, branches: list[ast.AST]) -> bool:
        for b in branches:
            for sub in ast.walk(b):
                if isinstance(sub, ast.Constant) and sub.value in ("cpu", "cuda"):
                    return True
                if isinstance(sub, ast.Call) and self._dotted(sub.func) == "torch.device":
                    return True
        return False

    def _check_availability(self, node, branches: list[ast.AST], always: bool):
        if not self.port or self.policy_module or not self._calls(node.test, _AVAILABLE):
            return
        if always or self._picks_device(branches):
            self._emit("RT002", node, "device chosen by torch.cuda.is_available(): use device.resolve_device, "
                                      "which raises without a card instead of falling back")

    # -- statements --

    def _visit_If(self, node: ast.If):
        self._check_availability(node, node.body + node.orelse, always=False)
        self._generic(node)

    def _visit_While(self, node: ast.While):
        self._check_availability(node, node.body + node.orelse, always=False)
        self._loop_body([node.test] + node.body)  # the test runs every iteration too
        self._visit_all(node.orelse)

    def _visit_For(self, node):
        self._visit(node.target)
        self._visit(node.iter)  # evaluated once
        self._loop_body(node.body)
        self._visit_all(node.orelse)

    _visit_AsyncFor = _visit_For

    def _loop_body(self, body):
        self._loop_depth += 1
        self._visit_all(body)
        self._loop_depth -= 1

    def _visit_comprehension_node(self, node, elements):
        first, *rest = node.generators
        self._visit(first.iter)  # evaluated once
        self._loop_depth += 1
        self._visit(first.target)
        self._visit_all(first.ifs)
        for gen in rest:
            self._visit(gen)
        self._visit_all(elements)
        self._loop_depth -= 1

    def _visit_ListComp(self, node):
        self._visit_comprehension_node(node, [node.elt])

    _visit_SetComp = _visit_ListComp
    _visit_GeneratorExp = _visit_ListComp

    def _visit_DictComp(self, node):
        self._visit_comprehension_node(node, [node.key, node.value])

    def _visit_Try(self, node):
        kernel_calls = [sub for stmt in node.body for sub in ast.walk(stmt)
                        if isinstance(sub, ast.Call) and self._is_kernel_call(sub)]
        if kernel_calls:
            for handler in node.handlers:
                if not self._reraises(handler):
                    self._emit("RT003", handler, "a kernel call's error is caught and not re-raised: a quiet "
                                                 "fallback; let it raise")
        self._generic(node)

    _visit_TryStar = _visit_Try

    def _is_kernel_call(self, call: ast.Call) -> bool:
        dotted = self._dotted(call.func)
        name = call.func.attr if isinstance(call.func, ast.Attribute) else getattr(call.func, "id", "")
        return name.endswith("_cuda") or (dotted is not None and (dotted == "build.library"
                                                                   or dotted.endswith(".build.library")))

    @staticmethod
    def _reraises(handler: ast.ExceptHandler) -> bool:
        stack = list(handler.body)
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Raise):
                return True
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
                stack.extend(ast.iter_child_nodes(n))
        return False

    # -- expressions --

    def _visit_IfExp(self, node: ast.IfExp):
        self._check_availability(node, [node.body, node.orelse], always=True)
        exempt = self._dtype_param is not None and any(
            isinstance(sub, ast.Name) and _is_dtype_param(sub.id) for sub in ast.walk(node.test))
        self._visit(node.test)
        self._rt004_exempt += exempt
        self._visit(node.body)
        self._visit(node.orelse)
        self._rt004_exempt -= exempt

    def _visit_Compare(self, node: ast.Compare):
        self._rt004_exempt += 1  # `x.dtype == torch.float32` tests a dtype, it does not pick one
        self._generic(node)
        self._rt004_exempt -= 1

    def _rt004_active(self) -> bool:
        return self.port and self._dtype_param is not None and not self._rt004_exempt

    def _visit_Attribute(self, node: ast.Attribute):
        if self._rt004_active() and self._dotted(node) == _F32:
            self._emit("RT004", node, f"hard-coded torch.float32 inside a function with a `{self._dtype_param}` "
                                      "parameter; derive the dtype from it")
        self._generic(node)

    def _visit_Call(self, node: ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute):
            if self._rt004_active() and func.attr == "float" and not node.args and not node.keywords:
                self._emit("RT004", node, f".float() inside a function with a `{self._dtype_param}` parameter; "
                                          "cast to the dtype it gives")
            if self.device_program and self._loop_depth > 0 and func.attr in _READBACK_METHODS:
                inner_cpu = (func.attr == "numpy" and isinstance(func.value, ast.Call)
                             and isinstance(func.value.func, ast.Attribute) and func.value.func.attr == "cpu")
                if not inner_cpu:  # `.cpu().numpy()` is one read-back, reported at .cpu()
                    self._emit("RT005", node, f".{func.attr}() inside a loop reads the device back every "
                                              "iteration")
        if self.device_program and self._loop_depth > 0 and self._dotted(func) == _SYNC:
            self._emit("RT005", node, "torch.cuda.synchronize() inside a loop waits for the card every iteration")
        self._generic(node)


def check_source(source: str, path: str = "<string>") -> list[Finding]:
    """Run every rule over one module's source; returns raw findings
    (suppressions and baselines are applied by the engine layer)."""
    tree = ast.parse(source, filename=path)
    return _Checker(tree, path, source.splitlines()).run()
