"""PAGE 2019-07-15 XML writer.

Port of origami_tpu/pagexml/pagexml.py with the standard library's
xml.etree.ElementTree in place of lxml: the same Metadata/Page/
TextRegion/TableRegion/GraphicRegion/TextLine/Coords/TextEquiv/
ReadingOrder elements, attributes, namespaces, coordinate strings and
element order, and `tostring()` writes the bytes lxml's
`tostring(pretty_print=True, xml_declaration=True, encoding="UTF-8")`
writes for such a document (two-space indents, `<a/>` for an element
without text or children, `<a></a>` for an empty text).

`validate()` keeps the structural checks (unique ids, no dangling
regionRef, at least 3 points per Coords). It does not validate against
the PRImA XSD, which needs lxml; the tests validate the port's output
against origami_tpu/pagexml/pagecontent.xsd with lxml instead.
"""

from __future__ import annotations

import datetime
import xml.etree.ElementTree as ET

import numpy as np

NS = "http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15"
XSI = "http://www.w3.org/2001/XMLSchema-instance"
SCHEMA_LOC = ("%s http://schema.primaresearch.org/PAGE/gts/pagecontent/"
              "2019-07-15/pagecontent.xsd") % NS


def _sub(parent, tag):
    """Child element in the PAGE namespace (written prefix-free)."""
    return ET.SubElement(parent, "{%s}%s" % (NS, tag))


def _coords_str(coords):
    pts = []
    for x, y in np.asarray(coords, dtype=np.float64).reshape(-1, 2):
        pts.append("%d,%d" % (max(0, round(x)), max(0, round(y))))
    return " ".join(pts)


class _Region:
    def __init__(self, element):
        self._e = element

    def append_coords(self, coords):
        c = _sub(self._e, "Coords")
        c.set("points", _coords_str(coords))

    def append_text_equiv(self, text, confidence=None):
        te = _sub(self._e, "TextEquiv")
        if confidence is not None:
            te.set("conf", "%.2f" % confidence)
        u = _sub(te, "Unicode")
        u.text = text


class TextRegion(_Region):
    def append_text_line(self, line_id=None):
        tl = _sub(self._e, "TextLine")
        if line_id:
            tl.set("id", line_id)
        return TextLine(tl)


class TextLine(_Region):
    def append_baseline(self, coords):
        b = _sub(self._e, "Baseline")
        b.set("points", _coords_str(coords))


class TableCell(TextRegion):
    """A table cell: a TextRegion nested in the TableRegion with a
    Roles/TableCellRole holding its grid position."""

    def __init__(self, element, row, col, row_span=None, col_span=None):
        super().__init__(element)
        self._role = (row, col, row_span, col_span)

    def append_coords(self, coords):
        # RegionType orders Roles right after Coords
        super().append_coords(coords)
        row, col, row_span, col_span = self._role
        roles = _sub(self._e, "Roles")
        role = _sub(roles, "TableCellRole")
        role.set("rowIndex", str(int(row)))
        role.set("columnIndex", str(int(col)))
        if row_span is not None:
            role.set("rowSpan", str(int(row_span)))
        if col_span is not None:
            role.set("colSpan", str(int(col_span)))


class TableRegionElement(_Region):
    def append_table_cell(self, row, col, cell_id=None, row_span=None,
                          col_span=None):
        tc = _sub(self._e, "TextRegion")
        if cell_id:
            tc.set("id", cell_id)
        return TableCell(tc, row, col, row_span, col_span)


# -- serialization as lxml writes it ------------------------------------------

def _escape_text(s):
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace("\r", "&#13;"))


def _escape_attr(s):
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;")
            .replace("\n", "&#10;").replace("\r", "&#13;")
            .replace("\t", "&#9;"))


def _qname(name):
    if not name.startswith("{"):
        return name
    if name.startswith("{%s}" % NS):
        return name[len(NS) + 2:]
    if name.startswith("{%s}" % XSI):
        return "xsi:" + name[len(XSI) + 2:]
    raise ValueError("unexpected namespace in %s" % name)


def _write(e, level, out, root=False):
    pad = "  " * level
    head = pad + "<" + _qname(e.tag)
    if root:
        head += ' xmlns="%s" xmlns:xsi="%s"' % (NS, XSI)
    for k, v in e.attrib.items():
        head += ' %s="%s"' % (_qname(k), _escape_attr(str(v)))
    children = list(e)
    if children:
        out.append(head + ">\n")
        for c in children:
            _write(c, level + 1, out)
        out.append(pad + "</%s>\n" % _qname(e.tag))
    elif e.text is not None:
        out.append(head + ">" + _escape_text(e.text)
                   + "</%s>\n" % _qname(e.tag))
    else:
        out.append(head + "/>\n")


class Page:
    """One PAGE document for one page image."""

    def __init__(self, filename, size):
        self._root = ET.Element("{%s}PcGts" % NS)
        self._root.set("{%s}schemaLocation" % XSI, SCHEMA_LOC)

        meta = _sub(self._root, "Metadata")
        _sub(meta, "Creator").text = "origami_tpu"
        now = datetime.datetime.now(
            datetime.timezone.utc).isoformat()
        _sub(meta, "Created").text = now
        _sub(meta, "LastChange").text = now

        self._page = _sub(self._root, "Page")
        self._page.set("imageFilename", str(filename))
        self._page.set("imageWidth", str(int(size[0])))
        self._page.set("imageHeight", str(int(size[1])))

    def append_reading_order(self, ordered_ids):
        ro = ET.Element("{%s}ReadingOrder" % NS)
        og = _sub(ro, "OrderedGroup")
        og.set("id", "ro_1")
        for i, rid in enumerate(ordered_ids):
            item = _sub(og, "RegionRefIndexed")
            item.set("index", str(i))
            item.set("regionRef", rid)
        # the schema wants ReadingOrder before the regions
        self._page.insert(0, ro)

    def append_region(self, kind, region_id, region_type=None):
        e = _sub(self._page, kind)
        e.set("id", region_id)
        if region_type and kind == "TextRegion":
            e.set("type", region_type)
        if kind == "TextRegion":
            return TextRegion(e)
        if kind == "TableRegion":
            return TableRegionElement(e)
        return _Region(e)

    def validate(self):
        """Structural checks; raises ValueError. (The JAX writer also
        validates against the PRImA XSD through lxml, which the port
        does not have.)"""
        ids = set()
        for e in self._page.iter():
            rid = e.get("id")
            if rid is not None:
                if rid in ids:
                    raise ValueError("duplicate id %s" % rid)
                ids.add(rid)
        for ref in self._page.iter("{%s}RegionRefIndexed" % NS):
            if ref.get("regionRef") not in ids:
                raise ValueError(
                    "dangling regionRef %s" % ref.get("regionRef"))
        for c in self._page.iter("{%s}Coords" % NS):
            pts = c.get("points", "")
            if len(pts.split()) < 3:
                raise ValueError("degenerate Coords %r" % pts)
        return True

    def tostring(self):
        out = ["<?xml version='1.0' encoding='UTF-8'?>\n"]
        _write(self._root, 0, out, root=True)
        return "".join(out).encode("utf-8")

    def write(self, file_or_path, validate=True):
        if validate:
            self.validate()
        data = self.tostring()
        if hasattr(file_or_path, "write"):
            file_or_path.write(data)
        else:
            with open(file_or_path, "wb") as f:
                f.write(data)
