"""Typed artifact I/O: Stage/Artifact registry, Reader/Writer, atomic writes.

Port of the parts of origami_tpu/batch/core/io.py that the nine detect
stages use (segment, contours, flow, dewarp, layout, lines, order, OCR,
compose).
Per-page `<image>.out/` directories hold the stage artifacts of
docs/formats.md; a stage declares its I/O as (name, Input/Output) pairs,
the runtime instantiates Readers/Writers, skips pages whose inputs are
missing or whose outputs exist, and passes them to `process()`.

Readers carry the processor's device: the `Page` they build uploads and
dewarps on it.
"""

from __future__ import annotations

import enum
import json
import os
import tempfile
import zipfile
from contextlib import contextmanager
from functools import cached_property
from pathlib import Path


def find_data_path(page_path):
    return Path(page_path).with_suffix(".out")


class Stage(enum.Enum):
    WARPED = 0
    DEWARPED = 1
    AGGREGATE = 2
    RELIABLE = 3
    ANY = -1

    @property
    def is_dewarped(self):
        return self.value >= Stage.DEWARPED.value


class Artifact(enum.Enum):
    SEGMENTATION = ("segment.zip", None)
    FLOW = ("flow.zip", None)
    DEWARPING_TRANSFORM = ("dewarp.zip", None)
    TABLES = ("tables.json", None)
    ORDER = ("order.json", None)
    OCR = ("ocr.zip", None)
    COMPOSE = ("compose.zip", None)
    RUNTIME = ("runtime.json", None)
    SIGNATURE = ("signature.zip", None)
    THUMBNAIL = ("thumbnail.jpg", None)
    DINGLEHOPPER = ("dinglehopper.xml", None)
    CONTOURS = ("contours.%d.zip",
                {Stage.WARPED: 0, Stage.DEWARPED: 1,
                 Stage.AGGREGATE: 2, Stage.RELIABLE: 3})
    LINES = ("lines.%d.zip",
             {Stage.WARPED: 0, Stage.RELIABLE: 3})

    def __init__(self, pattern, stages):
        self._pattern = pattern
        self._stage_variants = stages

    def filename(self, stage=None):
        if self._stage_variants is None:
            return self._pattern
        if stage is None:
            raise ValueError("%s needs a stage" % self)
        if stage not in self._stage_variants:
            raise ValueError("%s unsupported for %s" % (stage, self))
        return self._pattern % self._stage_variants[stage]


# ---------------------------------------------------------------------------
# file writers
# ---------------------------------------------------------------------------

@contextmanager
def atomic_write(path, mode="wb", overwrite=False):
    path = Path(path)
    if not overwrite and path.exists():
        raise FileExistsError(path)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.stem + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            yield f
        os.replace(tmp, path)
        tmp = None
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.remove(tmp)


class AtomicFileWriter:
    def __init__(self, overwrite=False):
        self.overwrite = overwrite

    def __call__(self, path, mode="wb"):
        return atomic_write(path, mode, overwrite=self.overwrite)


# ---------------------------------------------------------------------------
# contours zips
# ---------------------------------------------------------------------------

_BUILTIN_OPEN = open
_CONTOURS_PARSE_CACHE = {}


def read_contours_zip(path, pred_type=None, open=open):
    """Read back (items, folder_meta) from a contours zip; `items` is a
    list of ((pred, label, idx...), geometry) sorted by numeric index.

    Parses are memoized per (path, mtime, size, pred_type) when read with
    the builtin open (io.py:226-279): consecutive stages of a process
    re-read the same zips, and geometries are immutable by convention."""
    from origami_tpu_torch import geometry as G
    from origami_tpu_torch.core.segment import PredictorType
    cache_key = None
    if open is _BUILTIN_OPEN:
        try:
            st = os.stat(path)
            cache_key = (str(path), st.st_mtime_ns, st.st_size, pred_type)
        except OSError:
            cache_key = None
        hit = _CONTOURS_PARSE_CACHE.get(cache_key)
        if hit is not None:
            return list(hit[0]), hit[1]
    items = []
    folder_meta = {}
    with open(path, "rb") as f:
        with zipfile.ZipFile(f, "r") as zf:
            meta = json.loads(zf.read("meta.json"))
            types = {p["name"]: PredictorType[p["type"]]
                     for p in meta["predictions"]}

            def want(parts):
                return pred_type is None or types.get(parts[0]) == pred_type

            for name in zf.namelist():
                if name.endswith("/meta.json"):
                    parts = tuple(name.split("/"))
                    if want(parts):
                        folder_meta[tuple(parts[:-1])] = \
                            json.loads(zf.read(name))
                elif name.endswith(".wkt"):
                    parts = tuple(name[:-4].split("/"))
                    if want(parts):
                        items.append((parts, G.wkt.loads(
                            zf.read(name).decode("utf8"))))
    items.sort(key=lambda it: _numeric_path_key(it[0]))
    if cache_key is not None:
        if len(_CONTOURS_PARSE_CACHE) > 64:
            _CONTOURS_PARSE_CACHE.clear()
        _CONTOURS_PARSE_CACHE[cache_key] = (items, folder_meta)
        return list(items), folder_meta
    return items, folder_meta


def read_separators(path, open=open):
    """Separator geometries + per-separator widths from a contours zip."""
    from origami_tpu_torch.core.segment import PredictorType
    items, meta = read_contours_zip(path, PredictorType.SEPARATOR, open=open)
    seps = {parts: geom for parts, geom in items}
    widths = {}
    for folder, data in meta.items():
        for i, w in enumerate(data.get("width", [])):
            widths[folder + (str(i),)] = w
    return seps, widths


def _numeric_path_key(parts):
    """Sort key treating dotted numeric components numerically."""
    key = []
    for p in parts:
        segs = p.split(".")
        if segs and all(s.isdigit() for s in segs):
            key.append((0, "", tuple(int(s) for s in segs)))
        else:
            key.append((1, p, ()))
    return tuple(key)


# ---------------------------------------------------------------------------
# Reader / Writer
# ---------------------------------------------------------------------------

class Reader:
    def __init__(self, artifacts, stage, page_path, device, take_any=False,
                 open=open):
        artifacts = set(artifacts)
        # implied dependencies (io.py:314-320)
        if Artifact.LINES in artifacts:
            artifacts.add(Artifact.CONTOURS)
        if Artifact.CONTOURS in artifacts:
            artifacts.add(Artifact.SEGMENTATION)
        if stage and stage.is_dewarped and Artifact.CONTOURS in artifacts:
            artifacts.add(Artifact.DEWARPING_TRANSFORM)
        self._artifacts = artifacts
        self._stage = stage
        self._page_path = Path(page_path)
        self._data_path = find_data_path(page_path)
        self._device = device
        self._take_any = take_any
        self._open = open

    @property
    def stage(self):
        return self._stage

    @property
    def page_path(self):
        return self._page_path

    @property
    def data_path(self):
        return self._data_path

    @property
    def paths(self):
        return [self.path(a) for a in self._artifacts]

    def path(self, artifact):
        if artifact not in self._artifacts:
            raise KeyError("read on undeclared %s" % artifact)
        stage = self._stage
        if artifact is Artifact.LINES and stage is Stage.AGGREGATE:
            stage = Stage.WARPED
        return self._data_path / artifact.filename(stage)

    def fix_inconsistent(self):
        pass

    def is_ready(self):
        return self._take_any or all(p.exists() for p in self.paths)

    def load_json(self, artifact):
        with open(self.path(artifact), "r") as f:
            return json.load(f)

    @cached_property
    def page(self):
        from origami_tpu_torch.core.page import Page
        if self._stage is not None and self._stage.is_dewarped:
            return Page(self._page_path, self.grid, device=self._device)
        return Page(self._page_path, device=self._device)

    @cached_property
    def segmentation(self):
        from origami_tpu_torch.core.segment import Segmentation
        return Segmentation.open(
            self.path(Artifact.SEGMENTATION), open=self._open)

    @cached_property
    def contours(self):
        return read_contours_zip(
            self.path(Artifact.CONTOURS), None, open=self._open)[0]

    @cached_property
    def regions(self):
        from origami_tpu_torch.core.block import Block, Regions
        from origami_tpu_torch.core.segment import PredictorType
        items, _ = read_contours_zip(
            self.path(Artifact.CONTOURS), PredictorType.REGION,
            open=self._open)
        return Regions({parts: Block(self.page, geom, self._stage)
                        for parts, geom in items})

    @cached_property
    def separators(self):
        """Separators with their labels, which come from segment.zip's
        JSON entries (the label PNGs are not decoded)."""
        from origami_tpu_torch.core.segment import Segmentation
        from origami_tpu_torch.core.separate import Separators
        geoms, widths = read_separators(
            self.path(Artifact.CONTOURS), open=self._open)
        predictors = Segmentation.open_meta(
            self.path(Artifact.SEGMENTATION), open=self._open)
        return Separators(predictors, geoms, widths)

    @cached_property
    def lines(self):
        from origami_tpu_torch.core.block import Lines
        return Lines.open(self.path(Artifact.LINES), self.regions,
                          open=self._open)

    @cached_property
    def grid(self):
        from origami_tpu_torch.core.dewarp import Grid
        return Grid.open(self.path(Artifact.DEWARPING_TRANSFORM))

    @cached_property
    def flow(self):
        from origami_tpu_torch.core.flow import Samples
        out = {}
        with self._open(self.path(Artifact.FLOW), "rb") as f:
            with zipfile.ZipFile(f, "r") as zf:
                for kind in ("h", "v"):
                    out[kind] = Samples.from_zip(zf, kind)
        return out

    @cached_property
    def tables(self):
        return self.load_json(Artifact.TABLES)

    @cached_property
    def order(self):
        return self.load_json(Artifact.ORDER)

    @cached_property
    def ocr(self):
        texts = {}
        with self._open(self.path(Artifact.OCR), "rb") as f:
            with zipfile.ZipFile(f, "r") as zf:
                for name in zf.namelist():
                    texts[name] = zf.read(name).decode("utf8")
        return texts

    @property
    def sorted_ocr(self):
        """(path parts, text) of ocr.zip in numeric path order
        (io.py:448-453)."""
        def path_key(name):
            parts = tuple(name.rsplit(".", 1)[0].split("/"))
            return _numeric_path_key(parts), parts
        for key, parts in sorted(path_key(n) for n in self.ocr.keys()):
            yield parts, self.ocr["/".join(parts) + ".txt"]


class Writer:
    def __init__(self, artifacts, stage, page_path, file_writer):
        self._artifacts = set(artifacts)
        self._stage = stage
        self._data_path = find_data_path(page_path)
        self._write = file_writer

    @property
    def paths(self):
        return [self.path(a) for a in self._artifacts]

    def path(self, artifact):
        if artifact not in self._artifacts:
            raise KeyError("write on undeclared %s" % artifact)
        return self._data_path / artifact.filename(self._stage)

    def fix_inconsistent(self):
        """Remove partial multi-artifact outputs from a crashed run."""
        if self._write.overwrite:
            return
        exists = [p.exists() for p in self.paths]
        if any(exists) and not all(exists):
            for p in self.paths:
                if p.exists():
                    os.remove(p)

    def is_ready(self):
        return self._write.overwrite or not any(p.exists() for p in self.paths)

    @contextmanager
    def write_zip(self, artifact):
        with self._write(self.path(artifact), "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED) as zf:
                yield zf

    def write_json(self, artifact, data):
        with self._write(self.path(artifact), "wb") as f:
            f.write(json.dumps(data).encode("utf8"))

    def tables(self, data):
        self.write_json(Artifact.TABLES, data)

    def ocr(self):
        return self.write_zip(Artifact.OCR)

    def flow(self):
        return self.write_zip(Artifact.FLOW)

    def lines(self):
        return self.write_zip(Artifact.LINES)

    def compose(self):
        return self.write_zip(Artifact.COMPOSE)

    def order(self, data):
        self.write_json(Artifact.ORDER, data)

    @contextmanager
    def contours(self, copy_meta_from=None):
        """contours.N.zip; `copy_meta_from` (a Reader) supplies meta.json
        and the per-folder meta.json files of its contours zip."""
        with self.write_zip(Artifact.CONTOURS) as zf:
            if copy_meta_from is not None:
                src = copy_meta_from.path(Artifact.CONTOURS)
                with zipfile.ZipFile(src, "r") as sf:
                    zf.writestr("meta.json", sf.read("meta.json"))
                    for name in sf.namelist():
                        if name.endswith("/meta.json"):
                            zf.writestr(name, sf.read(name))
            yield zf

    @contextmanager
    def dewarping_transform(self):
        with self._write(self.path(Artifact.DEWARPING_TRANSFORM), "wb") as f:
            yield f

    def segmentation(self, segmentation):
        with self._write(self.path(Artifact.SEGMENTATION), "wb") as f:
            segmentation.save(f)


class Input:
    def __init__(self, *artifacts, stage=None, take_any=False):
        self._artifacts = set(artifacts)
        self._stage = stage
        self._take_any = take_any

    def instantiate(self, page_path, processor=None, file_writer=None,
                    device=None):
        """The reader's pages live on the processor's device, else on
        `device` (None: the card, raising without one)."""
        opener = processor.lock_or_open if processor is not None else open
        if processor is not None:
            device = processor.device
        return Reader(self._artifacts, self._stage, page_path, device,
                      take_any=self._take_any, open=opener)


class Output:
    def __init__(self, *artifacts, stage=None):
        self._artifacts = set(artifacts)
        self._stage = stage

    def instantiate(self, page_path, processor=None, file_writer=None):
        if file_writer is None:
            file_writer = AtomicFileWriter(overwrite=True)
        return Writer(self._artifacts, self._stage, page_path, file_writer)
