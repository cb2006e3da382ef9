"""Annotation database: ground-truth line transcriptions in SQLite.

Port of origami_tpu/tool/lineload.py: the same `lines` table (page_path,
line_path, annotation, author, training, validation), so a DB written by
one package is read by the other; and one GT line's image from the
page's reliable artifacts, on the card unless told otherwise.
"""

from __future__ import annotations

import sqlite3


class AnnotationDB:
    def __init__(self, path):
        self._path = str(path)
        self._conn = sqlite3.connect(self._path)
        self._conn.row_factory = sqlite3.Row
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS lines ("
            " page_path TEXT NOT NULL,"
            " line_path TEXT NOT NULL,"
            " annotation TEXT,"
            " author TEXT,"
            " training INTEGER DEFAULT 0,"
            " validation INTEGER DEFAULT 0,"
            " PRIMARY KEY (page_path, line_path))")
        self._conn.commit()

    def close(self):
        self._conn.close()

    def add_line(self, page_path, line_path, annotation=None, author=None,
                 training=0, validation=0):
        self._conn.execute(
            "INSERT OR IGNORE INTO lines "
            "(page_path, line_path, annotation, author, training, "
            "validation) VALUES (?, ?, ?, ?, ?, ?)",
            (str(page_path), str(line_path), annotation, author,
             training, validation))
        self._conn.commit()

    def remove_line(self, page_path, line_path):
        self._conn.execute(
            "DELETE FROM lines WHERE page_path = ? AND line_path = ?",
            (str(page_path), str(line_path)))
        self._conn.commit()

    def update_annotation(self, page_path, line_path, annotation,
                          author=None):
        self._conn.execute(
            "UPDATE lines SET annotation = ?, author = COALESCE(?, author)"
            " WHERE page_path = ? AND line_path = ?",
            (annotation, author, str(page_path), str(line_path)))
        self._conn.commit()

    def set_split(self, page_path, line_path, training, validation):
        self._conn.execute(
            "UPDATE lines SET training = ?, validation = ? "
            "WHERE page_path = ? AND line_path = ?",
            (int(training), int(validation), str(page_path),
             str(line_path)))
        self._conn.commit()

    def all_lines(self, annotated_only=False):
        q = "SELECT * FROM lines"
        if annotated_only:
            q += " WHERE annotation IS NOT NULL AND annotation != ''"
        return [dict(r) for r in self._conn.execute(q)]

    def lines_for_page(self, page_path):
        return [dict(r) for r in self._conn.execute(
            "SELECT * FROM lines WHERE page_path = ?", (str(page_path),))]

    def __len__(self):
        return self._conn.execute(
            "SELECT COUNT(*) FROM lines").fetchone()[0]


def load_line_image(page_path, line_path, line_height=48, column=None,
                    device=None):
    """One GT line's u8 strip from the page's reliable artifacts
    (Line.image: on a page with a grid, one remap_batch launch with the
    hard border). `device` None means the card, raising without one."""
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    reader = Input(Artifact.LINES, Artifact.TABLES,
                   stage=Stage.RELIABLE).instantiate(
        page_path=page_path, device=device)
    parts = tuple(str(line_path).split("/"))
    line = reader.lines.by_path.get(parts)
    if line is None:
        raise KeyError(line_path)
    return line.image(target_height=line_height, column=column)
