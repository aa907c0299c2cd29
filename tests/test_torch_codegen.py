"""The port's schema codegen (symbiont_tpu_torch/schema/codegen.py) against
the JAX package's and the committed `generated/` files.

The cases of tests/test_codegen_cpp.py, repeated on the port: every wire
message is encoded by the port's Python, parsed and re-emitted by the C++
the port generates (built with `g++` against native/json.hpp), and decoded
back field for field; the C++ keeps the strict decoder's rejections. Then
parity: the port's `gen_cpp()`/`gen_ts()` equal the committed files and
JAX's output on every line after the one HEADER line, which names the
generator.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import symbiont_tpu.schema as jschema
from symbiont_tpu.schema import codegen as jcodegen
from symbiont_tpu_torch import schema
from symbiont_tpu_torch.schema import codegen, from_json, to_json

REPO = Path(__file__).resolve().parent.parent

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")

HARNESS = r"""
#include <iostream>
#include <sstream>
#include <string>
#include "symbiont_schema.hpp"

using namespace symbiont;

std::string dispatch(const std::string& name, const std::string& line) {
DISPATCH
  throw std::runtime_error("unknown type " + name);
}

// Reads one JSON line per wire type in registry order, echoes the C++
// re-serialization; exercises parse() and to_json_string() for every struct.
int main() {
  std::string line;
  int i = 0;
  const char* names[] = {TYPE_LIST};
  while (std::getline(std::cin, line)) {
    std::string name = names[i++];
    try {
      std::cout << dispatch(name, line) << "\n";
    } catch (const std::exception& e) {
      std::cout << "ERROR " << name << ": " << e.what() << "\n";
      return 1;
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The port's generated header, compiled once into the echo harness."""
    tmp = tmp_path_factory.mktemp("codegen")
    outdir = tmp / "gen"
    codegen.main(str(outdir))
    names = [t.__name__ for t in schema.WIRE_TYPES]
    src = HARNESS.replace("TYPE_LIST", ", ".join(f'"{n}"' for n in names)).replace(
        "DISPATCH", "\n".join(f'  if (name == "{n}") return {n}::parse(line).to_json_string();'
                              for n in names))
    cpp = tmp / "harness.cpp"
    cpp.write_text(src)
    exe = tmp / "harness"
    subprocess.run(["g++", "-std=c++17", "-O1", "-o", str(exe), str(cpp),
                    "-I", str(REPO / "native"), "-I", str(outdir / "cpp")],
                   check=True, capture_output=True, text=True)
    return exe


def _sample(cls):
    """The port's instance of test_schema's fixture for `cls`."""
    from tests.test_schema import CASES

    for c in CASES:
        if type(c).__name__ == cls.__name__:
            return from_json(cls, jschema.to_json(c))
    raise AssertionError(f"no fixture for {cls}")


def _echo(exe, stdin: str):
    return subprocess.run([str(exe)], input=stdin, capture_output=True, text=True)


@needs_gxx
def test_cpp_round_trip_all_types(harness):
    msgs = [_sample(t) for t in schema.WIRE_TYPES]
    proc = _echo(harness, "\n".join(to_json(m) for m in msgs) + "\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().split("\n")
    assert len(lines) == len(msgs)
    for msg, line in zip(msgs, lines):
        assert from_json(type(msg), line) == msg, f"{type(msg).__name__}: {line}"


@needs_gxx
def test_cpp_rejects_malformed_numbers(harness):
    for bad in ('{"url": 01}', '{"url": .5}', '{"url": 1.}', '{"url": +1}'):
        assert _echo(harness, bad + "\n").returncode == 1, f"C++ accepted {bad!r}"


@needs_gxx
def test_cpp_rejects_unknown_field(harness):
    proc = _echo(harness, json.dumps({"url": "http://x", "extra": 1}) + "\n")
    assert proc.returncode == 1
    assert "unknown field" in proc.stdout


@needs_gxx
def test_cpp_missing_optional_ok(harness):
    # GenerateTextTask is 4th in registry order; feed prior types valid inputs
    stdin = "\n".join(to_json(_sample(t)) for t in schema.WIRE_TYPES[:3])
    stdin += "\n" + json.dumps({"task_id": "t", "max_length": 3}) + "\n"
    proc = _echo(harness, stdin)
    assert proc.returncode == 0, proc.stdout
    last = json.loads(proc.stdout.strip().split("\n")[-1])
    assert last["prompt"] is None and last["max_length"] == 3


def _after_header(text: str, header: str) -> list:
    lines = text.splitlines()
    assert lines[0] + "\n" == header
    return lines[1:]


@pytest.mark.parametrize("part", ["cpp/symbiont_schema.hpp", "ts/schema.ts"])
def test_committed_generated_files_in_sync(part):
    """generated/ is the JAX package's codegen output: the port's output
    equals it on every line after the HEADER line."""
    committed = (REPO / "generated" / part).read_text()
    mine = codegen.gen_cpp() if part.startswith("cpp") else codegen.gen_ts()
    assert _after_header(mine, codegen.HEADER) == _after_header(committed, jcodegen.HEADER)
    assert "symbiont_tpu_torch.schema.codegen" in codegen.HEADER


def test_output_equals_jax_codegen_and_cli_writes_both(tmp_path):
    assert [t.__name__ for t in schema.WIRE_TYPES] == [t.__name__ for t in jschema.WIRE_TYPES]
    assert (_after_header(codegen.gen_cpp(), codegen.HEADER)
            == _after_header(jcodegen.gen_cpp(), jcodegen.HEADER))
    out = subprocess.run([sys.executable, "-m", "symbiont_tpu_torch.schema.codegen",
                          str(tmp_path / "gen")], cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "gen" / "cpp" / "symbiont_schema.hpp").read_text() == codegen.gen_cpp()
    assert (tmp_path / "gen" / "ts" / "schema.ts").read_text() == codegen.gen_ts()


def test_refuses_to_write_into_the_committed_generated_dir():
    before = {p: p.read_bytes() for p in (REPO / "generated").rglob("*") if p.is_file()}
    with pytest.raises(SystemExit, match="JAX package's codegen output"):
        codegen.main(str(REPO / "generated"))
    assert {p: p.read_bytes() for p in (REPO / "generated").rglob("*") if p.is_file()} == before
