"""Minimal JSON-Schema validation for obs output files (zero-dependency).

The checked-in schemas under `schemas/` are written to the subset this
validator implements: `type`, `required`, `properties`,
`additionalProperties` (bool or schema), `items`, `enum`, `anyOf`,
`minimum`, `const`.  That keeps verify.sh's schema arm honest without
pulling in `jsonschema`.

CLI::

    python -m repro_torch.obs.validate trace.json --schema schemas/trace.schema.json

exits 0 when the file conforms, 1 with the first few violations printed
otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys

__all__ = ["validate", "validate_file", "main"]

_TYPE_CHECKS = {
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, list),
    "string": lambda v: isinstance(v, str),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "boolean": lambda v: isinstance(v, bool),
    "null": lambda v: v is None,
}


def validate(value, schema: dict, path: str = "$") -> list[str]:
    """Return a list of violation strings (empty == conforms)."""
    errors: list[str] = []

    if "anyOf" in schema:
        branches = schema["anyOf"]
        branch_errors = [validate(value, b, path) for b in branches]
        if all(be for be in branch_errors):
            first = min(branch_errors, key=len)
            errors.append(f"{path}: matched no anyOf branch (closest: {first[0]})")
        return errors

    if "const" in schema and value != schema["const"]:
        errors.append(f"{path}: expected const {schema['const']!r}, got {value!r}")

    if "enum" in schema and value not in schema["enum"]:
        errors.append(f"{path}: {value!r} not in enum {schema['enum']!r}")

    stype = schema.get("type")
    if stype is not None:
        types = stype if isinstance(stype, list) else [stype]
        if not any(_TYPE_CHECKS[t](value) for t in types):
            errors.append(f"{path}: expected type {stype}, got {type(value).__name__}")
            return errors

    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            errors.append(f"{path}: {value} < minimum {schema['minimum']}")

    if isinstance(value, dict):
        for req in schema.get("required", ()):
            if req not in value:
                errors.append(f"{path}: missing required key {req!r}")
        props = schema.get("properties", {})
        extra = schema.get("additionalProperties", True)
        for k, v in value.items():
            if k in props:
                errors.extend(validate(v, props[k], f"{path}.{k}"))
            elif extra is False:
                errors.append(f"{path}: unexpected key {k!r}")
            elif isinstance(extra, dict):
                errors.extend(validate(v, extra, f"{path}.{k}"))

    if isinstance(value, list) and "items" in schema:
        item_schema = schema["items"]
        for i, item in enumerate(value):
            errors.extend(validate(item, item_schema, f"{path}[{i}]"))

    return errors


def validate_file(data_path: str, schema_path: str) -> list[str]:
    with open(data_path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    with open(schema_path, "r", encoding="utf-8") as fh:
        schema = json.load(fh)
    return validate(data, schema)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="validate an obs JSON file against a schema")
    ap.add_argument("file", help="JSON file to validate")
    ap.add_argument("--schema", required=True, help="schema file (validator subset)")
    ap.add_argument("--max-errors", type=int, default=10)
    args = ap.parse_args(argv)

    errors = validate_file(args.file, args.schema)
    if errors:
        for e in errors[: args.max_errors]:
            print(f"FAIL {e}", file=sys.stderr)
        if len(errors) > args.max_errors:
            print(f"... and {len(errors) - args.max_errors} more", file=sys.stderr)
        return 1
    print(f"OK {args.file} conforms to {args.schema}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
