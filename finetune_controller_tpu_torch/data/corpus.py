"""On-box natural-language corpus assembly, no network egress (a copy of
the reference's ``data/corpus.py``).

The fidelity proof (``fidelity.py``) needs genuine
English text to pretrain a small base model — the reference's only example
trains on real MNIST digits (reference ``app/models/examples/mnist.py:13-99``),
and our equivalent north star is a fine-tune whose loss drop reflects a real
signal, not ``data/synthetic.py`` integer patterns.

The bench/test environment has no network, so the corpus is assembled from
text that ships with every CPython install: module/class/function docstrings
of a fixed stdlib list. That is real prose (sentences, headings, grammar) with
the statistics byte-level language modeling needs — a pretrained base scores
dramatically better on held-out English than a random-init model, which is
exactly the contrast the proof asserts.

Deterministic for a given CPython build (docstrings are versioned source).
"""

from __future__ import annotations

import importlib
import inspect
import re

#: fixed module list — broad, prose-heavy stdlib docs; deliberately NOT
#: "every importable module" (import side effects, platform variance)
_STDLIB_MODULES = [
    "argparse", "asyncio", "base64", "bisect", "calendar", "codecs",
    "collections", "configparser", "contextlib", "csv", "datetime",
    "difflib", "email", "enum", "fileinput", "fnmatch", "functools",
    "getpass", "gettext", "glob", "gzip", "hashlib", "heapq", "hmac",
    "html", "http", "imaplib", "inspect", "io", "ipaddress", "itertools",
    "json", "logging", "mailbox", "math", "mimetypes", "multiprocessing",
    "netrc", "ntpath", "numbers", "operator", "os", "pathlib", "pickle",
    "pickletools", "platform", "plistlib", "posixpath", "pprint",
    "profile", "queue", "random", "re", "sched", "secrets", "selectors",
    "shelve", "shlex", "shutil", "smtplib", "socket", "socketserver",
    "sqlite3", "ssl", "statistics", "string", "stringprep", "struct",
    "subprocess", "tarfile", "tempfile", "textwrap", "threading",
    "timeit", "tokenize", "traceback", "types", "typing", "unittest",
    "urllib.parse", "urllib.request", "uuid", "warnings", "wave",
    "weakref", "xml.dom", "xml.etree.ElementTree", "zipfile", "zlib",
]

_WS = re.compile(r"[ \t]+")


def _clean(doc: str) -> str:
    """Normalize a docstring toward plain prose: strip each line and collapse
    intra-line whitespace (indentation carries no language signal here).
    Length/quality filtering happens in :func:`build_corpus`."""
    lines = [_WS.sub(" ", ln.strip()) for ln in doc.strip().splitlines()]
    text = "\n".join(lines).strip()
    return text


def iter_docstrings(modules: list[str] | None = None):
    """Yield cleaned docstrings: each module's own doc plus its public
    classes', functions', and methods' docs. Import failures are skipped
    (the fixed list holds pure-stdlib names, but a trimmed container build
    must degrade to a smaller corpus, not crash)."""
    seen: set[int] = set()
    if modules is None:
        modules = _STDLIB_MODULES
    for name in modules:
        try:
            mod = importlib.import_module(name)
        except Exception:  # ftc: ignore[silent-except] -- trimmed container builds degrade to a smaller corpus by design (see docstring)
            continue
        if mod.__doc__:
            yield _clean(mod.__doc__)
        for _, member in inspect.getmembers(mod):
            if not (inspect.isclass(member) or inspect.isfunction(member)):
                continue
            if getattr(member, "__module__", None) != mod.__name__:
                continue  # re-exports would duplicate text across modules
            doc = inspect.getdoc(member)
            if doc and id(member) not in seen:
                seen.add(id(member))
                yield _clean(doc)
            if inspect.isclass(member):
                for _, meth in inspect.getmembers(member, inspect.isfunction):
                    mdoc = inspect.getdoc(meth)
                    if mdoc and id(meth) not in seen:
                        seen.add(id(meth))
                        yield _clean(mdoc)


def build_corpus(
    max_bytes: int = 400_000, *, min_doc_bytes: int = 120,
    modules: list[str] | None = None,
) -> list[str]:
    """Assemble up to ``max_bytes`` of English documents (longest sources
    first would bias toward a few modules; the fixed module order keeps the
    mix broad and deterministic)."""
    docs: list[str] = []
    total = 0
    for text in iter_docstrings(modules):
        raw = text.encode("utf-8")
        if len(raw) < min_doc_bytes:
            continue  # one-liners carry little modelable structure
        if not text.isascii():
            # byte-level vocab 256 handles any byte, but non-ASCII is rare
            # enough in docstrings to be noise rather than signal
            continue
        docs.append(text)
        total += len(raw)
        if total >= max_bytes:
            break
    if not docs:
        raise RuntimeError("no stdlib docstrings found — broken environment?")
    return docs


def write_corpus_jsonl(path, max_bytes: int = 400_000) -> int:
    """Write ``{"text": ...}`` rows for the data loader; returns corpus bytes."""
    import json

    docs = build_corpus(max_bytes)
    total = 0
    with open(path, "w") as f:
        for d in docs:
            f.write(json.dumps({"text": d}) + "\n")
            total += len(d.encode())
    return total
