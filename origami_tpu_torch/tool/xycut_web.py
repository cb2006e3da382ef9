"""Browser-based XY-cut debugger (stdlib http.server).

Port of origami_tpu/tool/xycut_web.py: the region boxes over the page
image; left/right (or the buttons) reveal the recursive cuts one at a
time, each drawn at its split position with its score; the side panel
lists the reading order. The cut tree comes from the port's
core/xycut, the order stage's scorer. `/image` of a dewarped stage is
Page.dewarped (one dewarp_u8 launch when the page cache is cold), on the
card unless told --device cpu, sent as PIL's JPEG bytes at quality 80,
as the JAX tool sends it.

    python -m origami_tpu_torch.tool.xycut_web CORPUS_DIR_OR_PAGE ... \\
        [--stage reliable] [--fringe 0.005] [--port 8397] \\
        [--host 127.0.0.1] [--device cpu]

and open (or SSH-port-forward) http://localhost:8397.
"""

from __future__ import annotations

import argparse
import json
import urllib.parse
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np

from origami_tpu_torch import device as _device
from origami_tpu_torch.tool import add_device_argument
from origami_tpu_torch.tool.pick_web import _collect_pages, page_image

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>origami_tpu xycut</title>
<style>
 body { font-family: sans-serif; margin: 1em; background: #f4f2ee; }
 #main { display: flex; gap: 1em; }
 #wrap { position: relative; flex: 1; }
 #page { display: block; max-width: 100%; opacity: .55; }
 #ov { position: absolute; left: 0; top: 0; width: 100%; height: 100%; }
 rect { fill: rgba(40,120,250,0.08); stroke: #2878fa; }
 line { stroke: #d33; stroke-width: 4; stroke-dasharray: 10 6; }
 text { font-size: 28px; fill: #123; font-weight: bold; }
 .cutlabel { font-size: 22px; fill: #d33; }
 #side { width: 22em; }
 #order { font-family: monospace; white-space: pre; font-size: .9em; }
 button, select { font-size: 1em; padding: .2em .6em; }
 #step { color: #666; margin-left: .6em; }
</style></head><body>
<div id="bar">
 <select id="pagesel"></select>
 <button onclick="move(-1)">&#8592; undo cut</button>
 <button onclick="move(1)">cut &#8594;</button>
 <span id="step"></span>
</div>
<div id="main">
 <div id="wrap"><img id="page" src="">
  <svg id="ov" xmlns="http://www.w3.org/2000/svg"></svg></div>
 <div id="side"><h3>reading order</h3><div id="order"></div></div>
</div>
<script>
let tree = null, cuts = [], step = 0, size = [1, 1], boxes = {},
    order = [];
function flatten(node, out) {       // preorder: cut sequence
  if (!node || !node.cut) return;
  out.push(node);
  flatten(node.a_node, out); flatten(node.b_node, out);
}
async function loadPages() {
  const pages = await (await fetch('/pages')).json();
  const sel = document.getElementById('pagesel');
  for (const p of pages) {
    const o = document.createElement('option');
    o.value = p; o.textContent = p; sel.appendChild(o);
  }
  sel.addEventListener('change', () => loadPage(sel.value));
  if (pages.length) loadPage(pages[0]);
}
async function loadPage(page) {
  const d = await (await fetch(
    '/tree?page=' + encodeURIComponent(page))).json();
  tree = d.tree; size = d.size; boxes = d.boxes; order = d.order;
  cuts = []; flatten(tree, cuts); step = 0;
  document.getElementById('page').src =
    '/image?page=' + encodeURIComponent(page);
  render();
}
function move(d) {
  step = Math.max(0, Math.min(cuts.length, step + d));
  render();
}
function render() {
  const svg = document.getElementById('ov');
  svg.setAttribute('viewBox', '0 0 ' + size[0] + ' ' + size[1]);
  svg.setAttribute('preserveAspectRatio', 'none');
  svg.innerHTML = '';
  const ns = 'http://www.w3.org/2000/svg';
  const rank = {};
  order.forEach((n, i) => rank[n] = i + 1);
  for (const [name, b] of Object.entries(boxes)) {
    const r = document.createElementNS(ns, 'rect');
    r.setAttribute('x', b[0]); r.setAttribute('y', b[1]);
    r.setAttribute('width', b[2] - b[0]);
    r.setAttribute('height', b[3] - b[1]);
    const t = document.createElementNS(ns, 'title');
    t.textContent = name; r.appendChild(t);
    svg.appendChild(r);
    const tx = document.createElementNS(ns, 'text');
    tx.setAttribute('x', b[0] + 8); tx.setAttribute('y', b[1] + 34);
    tx.textContent = rank[name] || '';
    svg.appendChild(tx);
  }
  for (let i = 0; i < step; i++) {
    const c = cuts[i];
    const l = document.createElementNS(ns, 'line');
    const e = c.extent;
    if (c.axis === 0) {
      l.setAttribute('x1', c.x); l.setAttribute('x2', c.x);
      l.setAttribute('y1', e[0]); l.setAttribute('y2', e[1]);
    } else {
      l.setAttribute('y1', c.x); l.setAttribute('y2', c.x);
      l.setAttribute('x1', e[0]); l.setAttribute('x2', e[1]);
    }
    svg.appendChild(l);
    const tx = document.createElementNS(ns, 'text');
    tx.setAttribute('class', 'cutlabel');
    tx.setAttribute('x', (c.axis === 0 ? c.x : e[0]) + 6);
    tx.setAttribute('y', (c.axis === 0 ? e[0] : c.x) + 26);
    tx.textContent = '#' + (i + 1) + ' s=' + c.score.toFixed(0) +
                     (c.overlap ? ' (overlap)' : '');
    svg.appendChild(tx);
  }
  document.getElementById('step').textContent =
    step + ' / ' + cuts.length + ' cuts';
  document.getElementById('order').textContent =
    order.map((n, i) => (i + 1) + '. ' + n).join('\\n');
}
document.addEventListener('keydown', e => {
  if (e.key === 'ArrowRight') move(1);
  if (e.key === 'ArrowLeft') move(-1);
});
loadPages();
</script></body></html>"""


def build_cut_tree(named, score="widest_gap"):
    """The full recursive cut tree over (name, (x0, y0, x1, y1)) items,
    as plain JSON: each node carries the cut axis / position / score
    and the two child node groups (tool/xycut.py's splitting path)."""
    from origami_tpu_torch.core import xycut
    from origami_tpu_torch.core.xycut import _axis_candidates, _split

    sc = xycut.SCORES[score]
    names = [n for n, _ in named]
    bounds = np.array([b for _, b in named],
                      np.float64).reshape(-1, 4)

    def build(idx):
        if len(idx) <= 1:
            return dict(cut=False, names=[names[i] for i in idx])
        cands = (_axis_candidates(bounds, idx, 0, sc, 0, 0.1)
                 + _axis_candidates(bounds, idx, 1, sc, 0, 0.1))
        if not cands:
            return dict(cut=False, names=[names[i] for i in idx])
        s, x, axis, overlap = max(cands, key=lambda c: c[0])
        a, b = _split(bounds, idx, axis, x, 0.1)
        lo = float(bounds[idx, 1 - axis].min())
        hi = float(bounds[idx, 3 - axis].max())
        return dict(
            cut=True, axis=int(axis), x=float(x), score=float(s),
            overlap=bool(overlap), extent=[lo, hi],
            a_node=build(a), b_node=build(b))

    return build(np.arange(len(named)))


def cut_tree(page_path, stage="reliable", fringe=0.005,
             score="widest_gap", device=None):
    """Cut tree + boxes + reading order for a processed page's region
    contours."""
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    from origami_tpu_torch.core import xycut

    st = Stage[stage.upper()]
    reader = Input(Artifact.CONTOURS, stage=st).instantiate(
        page_path=Path(page_path), device=device)
    page_geom = reader.page.geometry(st.is_dewarped)
    f = page_geom.rel_length(fringe)

    named, boxes = [], {}
    for parts, geom in reader.contours:
        if geom.geom_type != "Polygon" or geom.is_empty:
            continue
        name = "/".join(parts)
        minx, miny, maxx, maxy = geom.bounds
        boxes[name] = [minx, miny, maxx, maxy]
        named.append((name, (minx + f, miny + f, maxx - f, maxy - f)))

    size = reader.page.size(dewarped=st.is_dewarped)
    return dict(
        tree=build_cut_tree(named, score), boxes=boxes,
        size=[int(size[0]), int(size[1])],
        order=list(xycut.reading_order(named)))


def make_handler(pages, stage, fringe, device=None):
    """The request handler class for HTTPServer. `device` None means the
    card, raising without one."""
    from origami_tpu_torch.core import _jpeg
    device = _device.resolve(device)
    by_name = {str(p): p for p in pages}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code, body, ctype="text/html; charset=utf-8"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(url.query)
            if url.path == "/":
                self._send(200, _PAGE.encode("utf-8"))
            elif url.path == "/pages":
                self._send(200, json.dumps(
                    sorted(by_name.keys())).encode("utf-8"),
                    "application/json")
            elif url.path == "/tree":
                try:
                    out = cut_tree(by_name[q["page"][0]], stage, fringe,
                                   device=device)
                    self._send(200, json.dumps(out).encode("utf-8"),
                               "application/json")
                except Exception as e:
                    self._send(500, str(e).encode("utf-8"), "text/plain")
            elif url.path == "/image":
                try:
                    arr = page_image(by_name[q["page"][0]], stage, device)
                    self._send(200, _jpeg.encode(arr, 80), "image/jpeg")
                except Exception as e:
                    self._send(404, str(e).encode("utf-8"), "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.tool.xycut_web",
        description="Serve the browser XY-cut stepper for processed "
                    "pages in PATHS.")
    p.add_argument("paths", type=str, nargs="+")
    p.add_argument("--stage", type=str, default="reliable")
    p.add_argument("--fringe", type=float, default=0.005)
    p.add_argument("--port", type=int, default=8397)
    p.add_argument("--host", type=str, default="127.0.0.1")
    add_device_argument(p)
    args = p.parse_args(argv)
    for path in args.paths:
        if not Path(path).exists():
            raise SystemExit("no such path: %s" % path)
    pages = _collect_pages(args.paths)
    if not pages:
        raise SystemExit("no processed pages under %s" % (args.paths,))
    server = HTTPServer((args.host, args.port), make_handler(
        pages, args.stage, args.fringe, args.device))
    print("xycut UI on http://%s:%d (%d pages)"
          % (args.host, args.port, len(pages)))
    server.serve_forever()


if __name__ == "__main__":
    main()
