"""Transcription harmonization rule engine + CLI.

Port of origami_tpu/tool/harmonize.py. Schemas are Python literal dicts
(ast.literal_eval — data, not code) declaring channels with alphabets,
named transform chains and embedded self-tests:

    {"channels": {"default": {"transform": "t1", "alphabet": "...",
                              "tests": ["t"]}},
     "transforms": {"t1": [("unicode", "NFC"), ("str", "a", "b"),
                           ("re", "pat", "sub"), ("tfm", "other")]},
     "tests": {"t": [("input", "expected"), ...]}}

Rule kinds: str replace, regex sub, chained transform reference, unicode
normalization. Channels check their alphabet on every transform. Host
work only: `--device` is taken as every port CLI takes it.

    python -m origami_tpu_torch.tool.harmonize NAME --test [--device cpu]
    python -m origami_tpu_torch.tool.harmonize NAME --text TEXT [--channel C]
    python -m origami_tpu_torch.tool.harmonize NAME --db-path DB
"""

from __future__ import annotations

import argparse
import ast
import importlib
import re
import unicodedata
from pathlib import Path

from origami_tpu_torch import device as _device
from origami_tpu_torch.tool import add_device_argument


def _parse_str(s):
    if isinstance(s, str):
        return s
    if s[0] == "chr":
        return chr(s[1])
    raise ValueError(s)


def _compile_rule(rule, schema):
    kind = rule[0]
    if kind == "str":
        a, b = _parse_str(rule[1]), _parse_str(rule[2])
        return lambda s: s.replace(a, b)
    if kind == "re":
        pat = re.compile(rule[1])
        return lambda s: pat.sub(rule[2], s)
    if kind == "tfm":
        return lambda s: schema.transformer(rule[1])(s)
    if kind == "unicode":
        return lambda s: unicodedata.normalize(rule[1], s)
    raise ValueError("illegal rule %r" % (rule,))


class Transform:
    def __init__(self, schema, rules):
        self._rules = [_compile_rule(r, schema) for r in rules]

    def __call__(self, text):
        for r in self._rules:
            text = r(text)
        return text.strip()


class IllegalCharacter(ValueError):
    def __init__(self, text, index):
        self.text = text
        self.index = index
        super().__init__(
            "illegal character %r (0x%x) at %d in %r"
            % (text[index], ord(text[index]), index, text))


class Channel:
    def __init__(self, name, alphabet, transform, tests):
        self.name = name
        if alphabet is None:
            self._alphabet = None
        elif isinstance(alphabet, dict):
            self._alphabet = set("".join(alphabet.values()))
        else:
            self._alphabet = set(alphabet)
        self._transform = transform
        self.tests = tests

    @property
    def alphabet(self):
        return self._alphabet

    def transform(self, text):
        out = self._transform(text)
        if self._alphabet is not None:
            for i, c in enumerate(out):
                if c not in self._alphabet:
                    raise IllegalCharacter(out, i)
        return out

    def run_test(self, name, cases):
        failures = []
        for inp, expected in cases:
            got = self.transform(inp)
            if got != expected:
                failures.append((inp, expected, got))
        return failures


class Schema:
    def __init__(self, data):
        if isinstance(data, (str, Path)):
            data = ast.literal_eval(Path(data).read_text())
        self._data = data
        self._transforms = {}
        self.channels = {}
        for name, spec in data.get("channels", {}).items():
            self.channels[name] = Channel(
                name,
                spec.get("alphabet"),
                self.transformer(spec["transform"]),
                spec.get("tests", []))
        self.tests = data.get("tests", {})

    @classmethod
    def load(cls, name_or_path):
        """Load by module name
        (origami_tpu_torch.custom.harmonizations.<name>) or filesystem
        path."""
        p = Path(str(name_or_path))
        if p.exists():
            return cls(p)
        mod = importlib.import_module(
            "origami_tpu_torch.custom.harmonizations.%s" % name_or_path)
        return cls(mod.SCHEMA)

    def transformer(self, name):
        if name not in self._transforms:
            self._transforms[name] = Transform(
                self, self._data["transforms"][name])
        return self._transforms[name]

    def run_tests(self, verbose=True):
        ok = True
        for channel in self.channels.values():
            for test_name in channel.tests:
                failures = channel.run_test(
                    test_name, self.tests.get(test_name, []))
                status = "OK" if not failures else "FAIL"
                if verbose:
                    print("%s TEST channel %r (test %s)"
                          % (status, channel.name, test_name))
                    for inp, exp, got in failures:
                        print("  input:    %r" % inp)
                        print("  expected: %r" % exp)
                        print("  computed: %r" % got)
                ok = ok and not failures
        return ok


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.tool.harmonize",
        description="Apply or test harmonization schema SCHEMA_NAME.")
    p.add_argument("schema_name", type=str)
    p.add_argument("--test", dest="run_tests", action="store_true",
                   help="run the schema's embedded self-tests")
    p.add_argument("--text", type=str, default=None,
                   help="harmonize one text through the given channel")
    p.add_argument("--channel", type=str, default="default")
    p.add_argument("--db-path", type=str, default=None,
                   help="harmonize all annotations in this annotation DB "
                        "in place")
    add_device_argument(p)
    args = p.parse_args(argv)
    _device.resolve(args.device)
    if args.db_path is not None and not Path(args.db_path).exists():
        raise SystemExit("no such path: %s" % args.db_path)
    schema = Schema.load(args.schema_name)
    if args.run_tests:
        ok = schema.run_tests()
        raise SystemExit(0 if ok else 1)
    ch = schema.channels[args.channel]
    if args.text is not None:
        print(ch.transform(args.text))
        return
    if args.db_path:
        from origami_tpu_torch.tool.lineload import AnnotationDB
        db = AnnotationDB(args.db_path)
        n = 0
        for rec in db.all_lines():
            if rec["annotation"]:
                db.update_annotation(
                    rec["page_path"], rec["line_path"],
                    ch.transform(rec["annotation"]))
                n += 1
        print("harmonized %d annotations." % n)


if __name__ == "__main__":
    main()
