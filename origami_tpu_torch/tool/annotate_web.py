"""Browser-based GT transcription UI (stdlib http.server).

Port of origami_tpu/tool/annotate_web.py: one line strip at a time with
a text box; Enter saves and advances; arrows navigate; the filter box
restricts to unannotated lines. Writes go to the same annotations.db
the export and training tools read (tool/lineload.py). `/strip` loads
the line through tool/lineload.load_line_image (one remap_batch launch
on a page with a grid) on the card unless told --device cpu, as PNG.

    python -m origami_tpu_torch.tool.annotate_web --db-path DB \\
        [--port 8399] [--host 127.0.0.1] [--line-height 48] [--device cpu]

and open (or SSH-port-forward) http://localhost:8399.
"""

from __future__ import annotations

import argparse
import json
import urllib.parse
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

from origami_tpu_torch import device as _device
from origami_tpu_torch.tool import add_device_argument

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>origami_tpu annotate</title>
<style>
 body { font-family: sans-serif; margin: 2em; background: #f4f2ee; }
 #strip { border: 1px solid #999; background: #fff; max-width: 100%;
          image-rendering: pixelated; }
 #text { width: 100%; font-size: 1.3em; padding: .4em;
         font-family: serif; }
 #meta { color: #666; margin: .6em 0; }
 .nav { margin-top: .8em; }
 button { font-size: 1em; padding: .3em .9em; margin-right: .5em; }
 #status { margin-left: 1em; color: #2a7; }
</style></head><body>
<h2>origami_tpu line transcription</h2>
<label><input type="checkbox" id="only_blank"> only unannotated</label>
<div id="meta"></div>
<img id="strip" src="">
<div><input id="text" autocomplete="off"
            placeholder="transcription — Enter saves &amp; advances"></div>
<div class="nav">
 <button onclick="move(-1)">&#8592; prev</button>
 <button onclick="move(1)">next &#8594;</button>
 <button onclick="save(false)">save</button>
 <span id="status"></span>
</div>
<script>
let idx = 0, lines = [], dirty = false;
async function refresh() {
  const ob = document.getElementById('only_blank').checked;
  lines = await (await fetch('/lines?only_blank=' + (ob ? 1 : 0))).json();
  idx = Math.min(idx, Math.max(lines.length - 1, 0));
  show();
}
function show() {
  const s = document.getElementById('status');
  if (!lines.length) {
    document.getElementById('meta').textContent = 'no lines';
    return;
  }
  const l = lines[idx];
  document.getElementById('meta').textContent =
    (idx + 1) + ' / ' + lines.length + ' — ' + l.page_path + ' : ' +
    l.line_path;
  document.getElementById('strip').src =
    '/strip?page=' + encodeURIComponent(l.page_path) +
    '&line=' + encodeURIComponent(l.line_path);
  document.getElementById('text').value = l.annotation || '';
  s.textContent = '';
  dirty = false;
}
async function save(advance) {
  if (!lines.length) return;
  const l = lines[idx];
  const text = document.getElementById('text').value;
  await fetch('/save', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({page: l.page_path, line: l.line_path,
                          text: text})});
  l.annotation = text;
  document.getElementById('status').textContent = 'saved';
  if (advance) move(1);
}
function move(d) {
  idx = Math.max(0, Math.min(lines.length - 1, idx + d));
  show();
}
document.getElementById('text').addEventListener('keydown', e => {
  if (e.key === 'Enter') { e.preventDefault(); save(true); }
  if (e.key === 'ArrowDown') { e.preventDefault(); move(1); }
  if (e.key === 'ArrowUp') { e.preventDefault(); move(-1); }
});
document.getElementById('only_blank')
        .addEventListener('change', refresh);
refresh();
</script></body></html>"""


def make_handler(db_path, line_height, device=None):
    """The request handler class for HTTPServer. `device` None means the
    card, raising without one."""
    from origami_tpu_torch.core import _png
    from origami_tpu_torch.tool.lineload import AnnotationDB, load_line_image
    device = _device.resolve(device)

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
            elif url.path == "/lines":
                db = AnnotationDB(db_path)
                recs = db.all_lines()
                if q.get("only_blank", ["0"])[0] == "1":
                    recs = [r for r in recs if not r["annotation"]]
                out = [dict(page_path=r["page_path"],
                            line_path=r["line_path"],
                            annotation=r["annotation"]) for r in recs]
                self._send(200, json.dumps(out).encode("utf-8"),
                           "application/json")
            elif url.path == "/strip":
                page = q["page"][0]
                line = q["line"][0]
                try:
                    strip = load_line_image(page, line, line_height,
                                            device=device)
                    self._send(200, _png.encode_gray(strip), "image/png")
                except Exception as e:
                    self._send(404, str(e).encode("utf-8"),
                               "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/save":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", "0"))
            data = json.loads(self.rfile.read(n))
            db = AnnotationDB(db_path)
            db.add_line(data["page"], data["line"])
            db.update_annotation(data["page"], data["line"],
                                 data["text"])
            self._send(200, b"{}", "application/json")

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.tool.annotate_web",
        description="Serve the browser transcription UI for DB_PATH.")
    p.add_argument("--db-path", type=str, required=True)
    p.add_argument("--port", type=int, default=8399)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--line-height", type=int, default=48)
    add_device_argument(p)
    args = p.parse_args(argv)
    if not Path(args.db_path).exists():
        raise SystemExit("no such path: %s" % args.db_path)
    server = HTTPServer((args.host, args.port), make_handler(
        args.db_path, args.line_height, args.device))
    print("annotate UI on http://%s:%d (db: %s)"
          % (args.host, args.port, args.db_path))
    server.serve_forever()


if __name__ == "__main__":
    main()
