"""Browser-based GT line picking (stdlib http.server).

Port of origami_tpu/tool/pick_web.py: the page image under an SVG
overlay of the stage's line polygons (green = picked, in the DB;
outline = not picked); a click toggles. Writes go to the same
annotations.db the transcription UI, export and training tools read
(tool/lineload.py). `/image` of a dewarped stage is Page.dewarped (one
dewarp_u8 launch when the page cache is cold), on the card unless told
--device cpu, sent as PIL's JPEG bytes at quality 85, as the JAX tool
sends it.

    python -m origami_tpu_torch.tool.pick_web --db-path DB \\
        CORPUS_DIR_OR_PAGE ... [--stage reliable] [--port 8398] \\
        [--host 127.0.0.1] [--device cpu]

and open (or SSH-port-forward) http://localhost:8398.
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

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>origami_tpu pick</title>
<style>
 body { font-family: sans-serif; margin: 1em; background: #f4f2ee; }
 #wrap { position: relative; display: inline-block; }
 #page { display: block; max-width: 100%; }
 #ov { position: absolute; left: 0; top: 0; width: 100%; height: 100%; }
 polygon { fill: rgba(40,120,250,0.05); stroke: #2878fa;
           stroke-width: 1.5; cursor: pointer; }
 polygon.picked { fill: rgba(30,170,80,0.35); stroke: #1a5; }
 polygon:hover { fill: rgba(250,170,40,0.3); }
 #bar { margin-bottom: .6em; }
 select, button { font-size: 1em; padding: .2em .6em; }
 #status { margin-left: 1em; color: #2a7; }
</style></head><body>
<div id="bar">
 <select id="pagesel"></select>
 <button onclick="pickAll(true)">pick all</button>
 <button onclick="pickAll(false)">clear all</button>
 <span id="count"></span><span id="status"></span>
</div>
<div id="wrap">
 <img id="page" src="">
 <svg id="ov" xmlns="http://www.w3.org/2000/svg"></svg>
</div>
<script>
let lines = [], cur = null, size = [1, 1];
async function loadPages() {
  const pages = await (await fetch('/pages')).json();
  const sel = document.getElementById('pagesel');
  sel.innerHTML = '';
  for (const p of pages) {
    const o = document.createElement('option');
    o.value = p; o.textContent = p;
    sel.appendChild(o);
  }
  sel.addEventListener('change', () => loadPage(sel.value));
  if (pages.length) loadPage(pages[0]);
}
async function loadPage(page) {
  cur = page;
  const d = await (await fetch(
    '/lines?page=' + encodeURIComponent(page))).json();
  lines = d.lines; size = d.size;
  document.getElementById('page').src =
    '/image?page=' + encodeURIComponent(page);
  render();
}
function render() {
  const svg = document.getElementById('ov');
  svg.setAttribute('viewBox', '0 0 ' + size[0] + ' ' + size[1]);
  svg.setAttribute('preserveAspectRatio', 'none');
  svg.innerHTML = '';
  let n = 0;
  for (const l of lines) {
    const poly = document.createElementNS(
      'http://www.w3.org/2000/svg', 'polygon');
    poly.setAttribute('points', l.points);
    if (l.picked) { poly.classList.add('picked'); n += 1; }
    poly.addEventListener('click', () => toggle(l, poly));
    const t = document.createElementNS(
      'http://www.w3.org/2000/svg', 'title');
    t.textContent = l.path;
    poly.appendChild(t);
    svg.appendChild(poly);
  }
  document.getElementById('count').textContent =
    n + ' / ' + lines.length + ' picked';
}
async function toggle(l, poly) {
  const r = await fetch('/toggle', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({page: cur, line: l.path,
                          picked: !l.picked})});
  l.picked = (await r.json()).picked;
  render();
  document.getElementById('status').textContent =
    (l.picked ? 'picked ' : 'removed ') + l.path;
}
async function pickAll(on) {
  for (const l of lines) {
    if (l.picked !== on) {
      await fetch('/toggle', {method: 'POST',
        headers: {'Content-Type': 'application/json'},
        body: JSON.stringify({page: cur, line: l.path, picked: on})});
      l.picked = on;
    }
  }
  render();
}
loadPages();
</script></body></html>"""


def _collect_pages(paths):
    """Page image files (with a completed .out) under the given paths."""
    exts = {".png", ".jpg", ".jpeg", ".tif", ".tiff"}
    out = []
    for p in paths:
        p = Path(p)
        cands = sorted(p.iterdir()) if p.is_dir() else [p]
        for c in cands:
            if c.suffix.lower() in exts and \
                    (c.parent / (c.stem + ".out")).exists():
                out.append(c)
    return out


def _reader(page_path, stage, device):
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    st = Stage[stage.upper()]
    return st, Input(Artifact.LINES, stage=st).instantiate(
        page_path=Path(page_path), device=device)


def _page_lines(page_path, stage, device=None):
    """[(line_path_str, np_shell (N,2))] + page size for the stage."""
    st, reader = _reader(page_path, stage, device)
    out = []
    for parts, line in reader.lines.by_path.items():
        poly = line.image_space_polygon
        if poly is None or poly.is_empty:
            continue
        if hasattr(poly, "geoms"):
            poly = max(poly.geoms, key=lambda g: g.area)
        out.append(("/".join(parts), np.asarray(poly.np_shell)))
    size = reader.page.size(dewarped=st.is_dewarped)
    return out, size, reader


def page_image(page_path, stage, device=None):
    """The page's u8 pixels for the stage: Page.dewarped (dewarp_u8 on a
    cold page cache) or the scan."""
    st, reader = _reader(page_path, stage, device)
    page = reader.page
    return np.asarray(page.dewarped if st.is_dewarped else page.warped)


def make_handler(db_path, pages, stage, device=None):
    """The request handler class for HTTPServer. `device` None means the
    card, raising without one."""
    from origami_tpu_torch.core import _jpeg
    from origami_tpu_torch.tool.lineload import AnnotationDB

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
            elif url.path == "/lines":
                page = q["page"][0]
                db = AnnotationDB(db_path)
                picked = {r["line_path"]
                          for r in db.lines_for_page(page)}
                lines, size, _ = _page_lines(by_name[page], stage, device)
                out = dict(size=[int(size[0]), int(size[1])], lines=[
                    dict(path=p,
                         points=" ".join("%.1f,%.1f" % (x, y)
                                         for x, y in shell),
                         picked=p in picked)
                    for p, shell in lines])
                self._send(200, json.dumps(out).encode("utf-8"),
                           "application/json")
            elif url.path == "/image":
                page = q["page"][0]
                try:
                    arr = page_image(by_name[page], stage, device)
                    self._send(200, _jpeg.encode(arr, 85), "image/jpeg")
                except Exception as e:
                    self._send(404, str(e).encode("utf-8"), "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/toggle":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", "0"))
            data = json.loads(self.rfile.read(n))
            db = AnnotationDB(db_path)
            if data.get("picked"):
                db.add_line(data["page"], data["line"])
            else:
                db.remove_line(data["page"], data["line"])
            self._send(200, json.dumps(
                dict(picked=bool(data.get("picked")))).encode("utf-8"),
                "application/json")

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.tool.pick_web",
        description="Serve the browser line-picking UI for processed "
                    "pages in PATHS.")
    p.add_argument("paths", type=str, nargs="+")
    p.add_argument("--db-path", type=str, required=True)
    p.add_argument("--stage", type=str, default="reliable",
                   help="Artifact stage for line polygons "
                        "(reliable/warped).")
    p.add_argument("--port", type=int, default=8398)
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
        args.db_path, pages, args.stage, args.device))
    print("pick UI on http://%s:%d (%d pages, db: %s)"
          % (args.host, args.port, len(pages), args.db_path))
    server.serve_forever()


if __name__ == "__main__":
    main()
