"""Rule: cross-language wire-contract parity (``cpp-parity``).

Copy of the JAX package's `symbiont_tpu/lint/rules/parity.py`: the port's
`subjects.py`, `utils/telemetry.py`, `schema/frames.py` and `runner.py`
diffed against `native/services/common.hpp`.

Every wire contract in this stack exists twice: once in ``symbiont_tpu_torch/``
(the source of truth) and once in ``native/services/common.hpp`` + the C++
worker shells. The reference system shipped a dead limb exactly because
two halves of one contract drifted apart with nothing comparing them; a
drifted subject string, header name, SYTF dtype byte, or heartbeat payload
field here would fail the same way — silently, per-hop, with both sides
individually "working". This rule extracts the four contract surfaces from
the Python tree and diffs them against the native tree:

- **subject constants**: any constant name defined in BOTH
  ``subjects.py`` and ``common.hpp`` must carry the same string; any
  subject-shaped literal used anywhere in ``native/`` (``tasks.* / data.*
  / events.* / engine.* / _sys.*``) must exist in the Python subject
  table (a shell talking to a subject Python never defined IS the
  reference's orphaned-limb bug);
- **header names**: ``*_HEADER`` constants shared by name must match, and
  every ``X-Symbiont-*`` header literal in ``native/`` must appear
  somewhere in ``symbiont_tpu_torch/`` (``X-Symbus-*`` is the bus transport's
  own namespace and is exempt);
- **SYTF dtype registry**: magic, version, header length (computed from
  the Python struct format), per-dtype byte codes, per-dtype element
  sizes, and ``tensor/<name>`` content types must agree with the C++
  decoder;
- **heartbeat payload**: the JSON keys (and their order — the C++ side
  string-builds the payload for byte parity) built by
  ``runner._heartbeat_payload`` (capacity/draining autoscaler fields
  included) must match ``common.hpp heartbeat_payload``.

No allowlist: parity has no legitimate exceptions — fix whichever side
drifted."""

from __future__ import annotations

import ast
import re
import struct
from typing import Dict, List, Optional, Tuple

from symbiont_tpu_torch.lint.engine import Finding, LintContext, Rule

RULE_ID = "cpp-parity"

PY_SUBJECTS = "symbiont_tpu_torch/subjects.py"
PY_TELEMETRY = "symbiont_tpu_torch/utils/telemetry.py"
PY_FRAMES = "symbiont_tpu_torch/schema/frames.py"
PY_RUNNER = "symbiont_tpu_torch/runner.py"
CPP_COMMON = "native/services/common.hpp"

_CPP_STR_CONST = re.compile(
    r"inline\s+const\s+char\*\s+([A-Z][A-Z0-9_]*)\s*=\s*\"([^\"]*)\"\s*;")
_CPP_INT_CONST = re.compile(
    r"constexpr\s+(?:uint8_t|size_t|int|unsigned)\s+([A-Z][A-Z0-9_]*)\s*=\s*"
    r"(\d+)\s*;")
_SUBJECTISH = re.compile(
    r"\"((?:tasks|data|events|engine|_sys)\.[a-z0-9_.]+)\"")
_XSYM_HEADER = re.compile(r"X-Symbiont-[A-Za-z0-9-]+")
_CPP_ELEM_SIZE = re.compile(
    r"if\s*\(dtype\s*==\s*FRAME_DTYPE_([A-Z0-9]+)\)\s*return\s*(\d+)\s*;")
_CPP_HB_KEY = re.compile(r'\\"(\w+)\\":')


def _py_str_consts(ctx: LintContext, rel: str) -> Dict[str, str]:
    """Module-level NAME = "str" constants from one Python file."""
    path = ctx.root / rel
    if not path.is_file():
        return {}
    tree = ctx.tree(path)
    if tree is None:
        return {}
    out: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant):
            v = node.value.value
            if isinstance(v, str):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id.isupper():
                        out[tgt.id] = v
    return out


def _py_int_consts(ctx: LintContext, rel: str) -> Dict[str, int]:
    path = ctx.root / rel
    if not path.is_file():
        return {}
    tree = ctx.tree(path)
    if tree is None:
        return {}
    out: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant):
            v = node.value.value
            if isinstance(v, int) and not isinstance(v, bool):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id.isupper():
                        out[tgt.id] = v
    return out


def _line_of(text: str, needle: str) -> int:
    for i, line in enumerate(text.splitlines(), 1):
        if needle in line:
            return i
    return 0


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    common_path = ctx.root / CPP_COMMON
    if not common_path.is_file():
        return findings  # fixture trees without a native half: nothing to diff
    common = ctx.text(common_path)
    cpp_str = dict(_CPP_STR_CONST.findall(common))
    cpp_int = {k: int(v) for k, v in _CPP_INT_CONST.findall(common)}

    # ---------------------------------------------------- subject constants
    py_subjects = _py_str_consts(ctx, PY_SUBJECTS)
    subject_values = set(py_subjects.values())
    for name in sorted(set(py_subjects) & set(cpp_str)):
        if py_subjects[name] != cpp_str[name]:
            findings.append(Finding(
                CPP_COMMON, _line_of(common, name), RULE_ID, "error",
                f"subject constant {name} drifted: Python "
                f"{py_subjects[name]!r} vs C++ {cpp_str[name]!r}"))
    if py_subjects:
        for npath in ctx.native_files():
            text = ctx.text(npath)
            rel = ctx.rel(npath)
            for m in _SUBJECTISH.finditer(text):
                lit = m.group(1)
                if lit not in subject_values and not any(
                        v.startswith(lit + ".") or lit.startswith(v + ".")
                        for v in subject_values):
                    findings.append(Finding(
                        rel, text[:m.start()].count("\n") + 1, RULE_ID,
                        "error",
                        f"native literal subject {lit!r} exists in no "
                        f"Python subjects.py constant — a shell wired to a "
                        "subject the rest of the stack never serves"))

    # --------------------------------------------------------- header names
    py_headers: Dict[str, str] = {}
    for rel in (PY_TELEMETRY, PY_FRAMES):
        py_headers.update({k: v for k, v in _py_str_consts(ctx, rel).items()
                           if k.endswith("_HEADER")})
    for name in sorted(set(py_headers) & set(cpp_str)):
        if py_headers[name] != cpp_str[name]:
            findings.append(Finding(
                CPP_COMMON, _line_of(common, name), RULE_ID, "error",
                f"header constant {name} drifted: Python "
                f"{py_headers[name]!r} vs C++ {cpp_str[name]!r}"))
    if py_headers:
        py_tree_headers = set()
        for p in ctx.py_files("symbiont_tpu_torch"):
            py_tree_headers |= set(_XSYM_HEADER.findall(ctx.text(p)))
        for npath in ctx.native_files():
            text = ctx.text(npath)
            rel = ctx.rel(npath)
            for m in _XSYM_HEADER.finditer(text):
                h = m.group(0)
                # trailing-dash prefix forms ("X-Symbiont-DLQ" matching the
                # DLQ-* family) resolve against full names
                if h in py_tree_headers or any(
                        ph.startswith(h) for ph in py_tree_headers):
                    continue
                findings.append(Finding(
                    rel, text[:m.start()].count("\n") + 1, RULE_ID, "error",
                    f"native header {h!r} appears nowhere in symbiont_tpu_torch/ "
                    "— one half of a wire contract"))

    # ------------------------------------------------------- dtype registry
    frames_path = ctx.root / PY_FRAMES
    if frames_path.is_file():
        py_ints = _py_int_consts(ctx, PY_FRAMES)
        ftext = ctx.text(frames_path)
        dtypes = {n[len("DTYPE_"):].lower(): v
                  for n, v in py_ints.items() if n.startswith("DTYPE_")}
        for name, code in sorted(dtypes.items()):
            cpp_name = f"FRAME_DTYPE_{name.upper()}"
            if cpp_name not in cpp_int:
                findings.append(Finding(
                    CPP_COMMON, 0, RULE_ID, "error",
                    f"SYTF dtype {name!r} (byte {code}) has no C++ "
                    f"{cpp_name} — the dtype is half-wired: decodable on "
                    "Python hops, FrameError on native ones"))
            elif cpp_int[cpp_name] != code:
                findings.append(Finding(
                    CPP_COMMON, _line_of(common, cpp_name), RULE_ID,
                    "error",
                    f"SYTF dtype byte drifted for {name!r}: Python {code} "
                    f"vs C++ {cpp_int[cpp_name]}"))
            if f"tensor/{name}" not in common:
                findings.append(Finding(
                    CPP_COMMON, 0, RULE_ID, "error",
                    f"content type 'tensor/{name}' missing from C++ "
                    "(frame_header_value/split_frame would reject it)"))
        if "FRAME_VERSION" in py_ints and cpp_int.get(
                "FRAME_VERSION") != py_ints["FRAME_VERSION"]:
            findings.append(Finding(
                CPP_COMMON, _line_of(common, "FRAME_VERSION"), RULE_ID,
                "error",
                f"SYTF version drifted: Python {py_ints['FRAME_VERSION']} "
                f"vs C++ {cpp_int.get('FRAME_VERSION')}"))
        hdr = re.search(r"struct\.Struct\(\"([^\"]+)\"\)", ftext)
        if hdr and "FRAME_HDR_LEN" in cpp_int:
            want = struct.calcsize(hdr.group(1))
            if cpp_int["FRAME_HDR_LEN"] != want:
                findings.append(Finding(
                    CPP_COMMON, _line_of(common, "FRAME_HDR_LEN"), RULE_ID,
                    "error",
                    f"frame header length drifted: Python struct "
                    f"{hdr.group(1)!r} is {want} bytes vs C++ "
                    f"FRAME_HDR_LEN {cpp_int['FRAME_HDR_LEN']}"))
        magic = re.search(r"FRAME_MAGIC\s*=\s*b\"(\w+)\"", ftext)
        if magic and f'"{magic.group(1)}"' not in common:
            findings.append(Finding(
                CPP_COMMON, 0, RULE_ID, "error",
                f"frame magic {magic.group(1)!r} missing from C++"))
        sizes = _py_elem_sizes(ctx)
        cpp_sizes = {n.lower(): int(s)
                     for n, s in _CPP_ELEM_SIZE.findall(common)}
        for name, size in sorted(sizes.items()):
            if name in cpp_sizes and cpp_sizes[name] != size:
                findings.append(Finding(
                    CPP_COMMON, _line_of(common, "frame_elem_size"),
                    RULE_ID, "error",
                    f"SYTF element size drifted for {name!r}: Python "
                    f"{size} vs C++ {cpp_sizes[name]}"))
            elif dtypes and name in dtypes and name not in cpp_sizes:
                findings.append(Finding(
                    CPP_COMMON, _line_of(common, "frame_elem_size"),
                    RULE_ID, "error",
                    f"C++ frame_elem_size has no case for dtype {name!r}"))

    # ----------------------------------------------------- heartbeat payload
    runner_path = ctx.root / PY_RUNNER
    if runner_path.is_file() and "heartbeat_payload" in common:
        py_keys = _runner_heartbeat_keys(ctx)
        cpp_keys = _CPP_HB_KEY.findall(
            _cpp_function_body(common, "heartbeat_payload"))
        if py_keys and cpp_keys and py_keys != cpp_keys:
            findings.append(Finding(
                CPP_COMMON, _line_of(common, "heartbeat_payload"), RULE_ID,
                "error",
                f"heartbeat payload fields drifted: Python publishes "
                f"{py_keys} but C++ builds {cpp_keys} (byte parity is the "
                "contract — tests/test_fleet.py pins it at runtime, this "
                "pins it at review time)"))
    return findings


def _py_elem_sizes(ctx: LintContext) -> Dict[str, int]:
    """frames.py _SIZE_BY_DTYPE dict → {"f32": 4, ...} (keys are the
    DTYPE_* names resolved through the module's int constants)."""
    tree = ctx.tree(ctx.root / PY_FRAMES)
    if tree is None:  # syntax error: already a lint-parse finding
        return {}
    ints = _py_int_consts(ctx, PY_FRAMES)
    by_code = {v: k[len("DTYPE_"):].lower() for k, v in ints.items()
               if k.startswith("DTYPE_")}
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name)
                        and t.id == "_SIZE_BY_DTYPE"
                        for t in node.targets)
                and isinstance(node.value, ast.Dict)):
            for k, v in zip(node.value.keys, node.value.values):
                name = None
                if isinstance(k, ast.Name):
                    name = by_code.get(ints.get(k.id))
                elif isinstance(k, ast.Constant):
                    name = by_code.get(k.value)
                if name and isinstance(v, ast.Constant):
                    out[name] = v.value
    return out


def _runner_heartbeat_keys(ctx: LintContext) -> List[str]:
    """The runner's heartbeat JSON keys, in publish order: the first
    json.dumps(dict-literal) inside `_heartbeat_payload` (the builder the
    loop and the drain protocol's final beat share) or, for older trees,
    `_heartbeat_loop` itself."""
    tree = ctx.tree(ctx.root / PY_RUNNER)
    if tree is None:
        return []
    for fn_name in ("_heartbeat_payload", "_heartbeat_loop"):
        for node in ast.walk(tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name == fn_name):
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr == "dumps" and sub.args
                            and isinstance(sub.args[0], ast.Dict)):
                        return [k.value for k in sub.args[0].keys
                                if isinstance(k, ast.Constant)]
    return []


def _cpp_function_body(text: str, name: str) -> str:
    """Naive brace-matched body of one C++ function (our own header — the
    formatting is under this repo's control)."""
    start = text.find(f" {name}(")
    if start < 0:
        return ""
    brace = text.find("{", start)
    if brace < 0:
        return ""
    depth, i = 1, brace + 1
    while i < len(text) and depth:
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    return text[brace:i]


RULES = [Rule(
    id=RULE_ID,
    doc="subjects, X-Symbiont-* headers, SYTF dtype registry, and "
        "heartbeat payload fields must match between symbiont_tpu_torch/ and "
        "the native C++ tree exactly",
    check=check,
)]
