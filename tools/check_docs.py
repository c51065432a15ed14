#!/usr/bin/env python3
"""API documentation check (the reference's rustdoc gate,
lzma-rs .github/workflows/rustdoc.yml, adapted to Python).

Fails if any public symbol reachable from the package surface — the
8 reference-parity entry points, the option/stream classes, and every
public module under lzma_rs_tpu/ — is missing a docstring, and builds
the pydoc HTML pages to catch malformed ones. Run: python tools/check_docs.py
"""

import importlib
import inspect
import os
import pkgutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    for n in names:
        obj = getattr(mod, n, None)
        # only flag symbols DEFINED here (re-exports are checked once, at
        # their defining module)
        if getattr(obj, "__module__", None) == mod.__name__ and (
            inspect.isfunction(obj) or inspect.isclass(obj)
        ):
            yield n, obj


# User-facing classes whose every public method must be documented
# (mirrors the reference's public rustdoc surface: Stream, options, raw).
API_CLASSES = {
    "Stream", "Lzma2Stream", "XzStream", "Options", "CompressOptions",
    "UnpackedSize", "WriteUnpackedSize", "LzmaDecoder", "Lzma2Decoder",
    "LzmaParams", "LzmaProperties", "DecodeStats",
}


def main() -> int:
    import lzma_rs_tpu

    missing = []
    mods = [lzma_rs_tpu]
    pkg_dir = os.path.dirname(lzma_rs_tpu.__file__)
    for info in pkgutil.walk_packages([pkg_dir], prefix="lzma_rs_tpu."):
        if ".native" in info.name:
            continue  # ctypes loader builds C++ lazily; skip import side effects
        try:
            mods.append(importlib.import_module(info.name))
        except Exception as e:  # import failure is itself a doc-build failure
            missing.append(f"{info.name}: import failed: {e}")

    for mod in mods:
        if not (mod.__doc__ or "").strip():
            missing.append(f"{mod.__name__}: module missing docstring")
        for name, obj in public_members(mod):
            if not (inspect.getdoc(obj) or "").strip():
                missing.append(f"{mod.__name__}.{name}: missing docstring")
            # method docstrings are required on the user-facing API
            # surface (the reference-parity entry classes); internal
            # helper classes need only a class docstring
            if inspect.isclass(obj) and name in API_CLASSES:
                for mname, m in vars(obj).items():
                    if mname.startswith("_") or not inspect.isfunction(m):
                        continue
                    if not (inspect.getdoc(m) or "").strip():
                        missing.append(
                            f"{mod.__name__}.{name}.{mname}: missing docstring"
                        )

    # pydoc HTML build (catches symbols whose signatures cannot render)
    import pydoc

    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            for mod in mods:
                pydoc.writedoc(mod)
        finally:
            os.chdir(cwd)

    if missing:
        print(f"DOC CHECK FAILED ({len(missing)}):")
        for m in sorted(set(missing)):
            print(" -", m)
        return 1
    print(f"doc check OK: {len(mods)} modules, all public symbols documented")
    return 0


if __name__ == "__main__":
    sys.exit(main())
