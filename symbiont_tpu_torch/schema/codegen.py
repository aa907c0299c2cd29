"""Generate C++ structs and TypeScript interfaces from the Python wire schema.

Copy of the JAX package's `symbiont_tpu/schema/codegen.py`, over the port's
`schema` (the same 13 wire structs): its output equals the committed
`generated/` files on every line after the `HEADER` line, which names the
generator that wrote it.

Fixes the reference's hand-sync flaw: Rust structs
(reference: libs/shared_models/src/lib.rs:3-110) and TS mirrors
(reference: frontend/src/app/page.tsx:7-48) were kept in sync by hand. Here both
native and frontend type surfaces are generated from the wire schema.

Usage: python -m symbiont_tpu_torch.schema.codegen <outdir>
Writes <outdir>/cpp/symbiont_schema.hpp and <outdir>/ts/schema.ts.
The C++ side depends on native/json.hpp (hand-written minimal JSON lib).
The repo's committed `generated/` is the JAX package's output and is
refused as an outdir.
"""

from __future__ import annotations

import dataclasses
import sys
import typing
from pathlib import Path
from typing import List, get_args, get_origin

from symbiont_tpu_torch import schema

HEADER = "// GENERATED by symbiont_tpu_torch.schema.codegen — DO NOT EDIT.\n"


def _cpp_type(tp) -> str:
    origin = get_origin(tp)
    if origin is typing.Union:  # Optional[X]
        inner = [a for a in get_args(tp) if a is not type(None)][0]
        return f"std::optional<{_cpp_type(inner)}>"
    if origin in (list, List):
        (elem,) = get_args(tp)
        return f"std::vector<{_cpp_type(elem)}>"
    if tp is str:
        return "std::string"
    if tp is bool:
        return "bool"
    if tp is int:
        return "uint64_t"
    if tp is float:
        return "float"
    if dataclasses.is_dataclass(tp):
        return tp.__name__
    raise TypeError(f"unsupported schema type: {tp}")


def _ts_type(tp) -> str:
    origin = get_origin(tp)
    if origin is typing.Union:
        inner = [a for a in get_args(tp) if a is not type(None)][0]
        return f"{_ts_type(inner)} | null"
    if origin in (list, List):
        (elem,) = get_args(tp)
        return f"{_ts_type(elem)}[]"
    if tp is str:
        return "string"
    if tp is bool:
        return "boolean"
    if tp in (int, float):
        return "number"
    if dataclasses.is_dataclass(tp):
        return tp.__name__
    raise TypeError(f"unsupported schema type: {tp}")


def _cpp_to_json_expr(name: str, tp) -> str:
    """Expression converting member `name` of type tp into a json::Value."""
    origin = get_origin(tp)
    if origin is typing.Union:
        inner = [a for a in get_args(tp) if a is not type(None)][0]
        return f"({name} ? {_cpp_to_json_expr('(*' + name + ')', inner)} : json::Value())"
    if origin in (list, List):
        (elem,) = get_args(tp)
        return f"json::to_array({name}, [](const {_cpp_type(elem)}& v) {{ return {_cpp_to_json_expr('v', elem)}; }})"
    if dataclasses.is_dataclass(tp):
        return f"{name}.to_json()"
    if tp is bool:
        return f"json::Value((bool){name})"
    if tp is int:
        return f"json::Value((double){name})"
    return f"json::Value({name})"


def _cpp_from_json_stmt(name: str, tp, src: str) -> str:
    """Statement decoding json::Value `src` into member `out.name`."""
    origin = get_origin(tp)
    if origin is typing.Union:
        inner = [a for a in get_args(tp) if a is not type(None)][0]
        tmp = f"opt_{name}"
        inner_decl = _cpp_from_json_stmt(tmp, inner, src)
        return (
            f"if (!{src}.is_null()) {{ {_cpp_type(inner)} {tmp}{{}}; "
            f"{inner_decl.replace('out.' + tmp, tmp)} out.{name} = std::move({tmp}); }}"
        )
    if origin in (list, List):
        (elem,) = get_args(tp)
        et = _cpp_type(elem)
        body = _cpp_from_json_stmt("item", elem, "e").replace("out.item", "item")
        return (
            f"for (const auto& e : {src}.as_array()) {{ {et} item{{}}; {body} "
            f"out.{name}.push_back(std::move(item)); }}"
        )
    if dataclasses.is_dataclass(tp):
        return f"out.{name} = {tp.__name__}::from_json({src});"
    if tp is bool:
        return f"out.{name} = {src}.as_bool();"
    if tp is int:
        return f"out.{name} = {src}.as_u64();"
    if tp is float:
        return f"out.{name} = (float){src}.as_number();"
    return f"out.{name} = {src}.as_string();"


def gen_cpp() -> str:
    out = [
        HEADER,
        "#pragma once",
        "#include <cstdint>",
        "#include <optional>",
        "#include <string>",
        "#include <vector>",
        '#include "json.hpp"',
        "",
        "namespace symbiont {",
        "",
    ]
    for cls in schema.WIRE_TYPES:
        hints = typing.get_type_hints(cls)
        fields = dataclasses.fields(cls)
        out.append(f"struct {cls.__name__} {{")
        for f in fields:
            out.append(f"  {_cpp_type(hints[f.name])} {f.name}{{}};")
        # to_json
        out.append("  json::Value to_json() const {")
        out.append("    json::Value o = json::Value::object();")
        for f in fields:
            out.append(f'    o.set("{f.name}", {_cpp_to_json_expr(f.name, hints[f.name])});')
        out.append("    return o;")
        out.append("  }")
        out.append("  std::string to_json_string() const { return to_json().dump(); }")
        # from_json — decode semantics mirror the Python strict decoder
        # (schema.from_dict): unknown fields rejected, missing optional → empty.
        out.append(f"  static {cls.__name__} from_json(const json::Value& j) {{")
        out.append(f"    {cls.__name__} out{{}};")
        known = ", ".join(f'"{f.name}"' for f in fields)
        out.append(f"    j.check_known_fields({{{known}}});")
        for f in fields:
            tp = hints[f.name]
            if get_origin(tp) is typing.Union:  # Optional: tolerate absence
                out.append(f'    if (j.has("{f.name}")) {{ const json::Value& v = '
                           f'j.at("{f.name}"); {_cpp_from_json_stmt(f.name, tp, "v")} }}')
            else:
                out.append(f'    {{ const json::Value& v = j.at("{f.name}"); '
                           f"{_cpp_from_json_stmt(f.name, tp, 'v')} }}")
        out.append("    return out;")
        out.append("  }")
        out.append(f"  static {cls.__name__} parse(const std::string& s) "
                   f"{{ return from_json(json::parse(s)); }}")
        out.append("};")
        out.append("")
    out.append("}  // namespace symbiont")
    return "\n".join(out) + "\n"


def gen_ts() -> str:
    out = [HEADER, ""]
    for cls in schema.WIRE_TYPES:
        hints = typing.get_type_hints(cls)
        out.append(f"export interface {cls.__name__} {{")
        for f in dataclasses.fields(cls):
            out.append(f"  {f.name}: {_ts_type(hints[f.name])};")
        out.append("}")
        out.append("")
    return "\n".join(out)


def main(outdir: str) -> None:
    root = Path(outdir)
    committed = Path(__file__).resolve().parents[2] / "generated"
    if root.resolve() == committed:
        raise SystemExit(f"{committed} holds the JAX package's codegen output; "
                         "write the port's somewhere else")
    (root / "cpp").mkdir(parents=True, exist_ok=True)
    (root / "ts").mkdir(parents=True, exist_ok=True)
    (root / "cpp" / "symbiont_schema.hpp").write_text(gen_cpp())
    (root / "ts" / "schema.ts").write_text(gen_ts())
    print(f"wrote {root}/cpp/symbiont_schema.hpp and {root}/ts/schema.ts")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
