"""Browser-based corpus cluster explorer (stdlib http.server).

Port of origami_tpu/tool/cluster_web.py: the pages grouped by the same
k-means over grid-count signatures as tool/cluster.py (run
batch.utils.signature over the corpus first), each cluster's page
thumbnails, a page at full size. The images are the page in gray,
narrowed to 360 (thumbnail) or 2400 (full) pixels as PIL's default
BICUBIC `resize` narrows it (batch/utils/thumbnail.resize_bicubic),
sent as PIL's JPEG bytes at quality 80 with the page's comment
(core/_image.comment), as the JAX tool sends them. Host work only:
`--device` is taken as every port CLI takes it.

    python -m origami_tpu_torch.tool.cluster_web CORPUS [-k 8] \\
        [--port 8396] [--host 127.0.0.1] [--device cpu]

and open (or SSH-port-forward) http://localhost:8396.
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
<html><head><meta charset="utf-8"><title>origami_tpu clusters</title>
<style>
 body { font-family: sans-serif; margin: 1em; background: #f4f2ee; }
 #clusters { display: flex; gap: .4em; flex-wrap: wrap;
             margin-bottom: 1em; }
 .cbtn { padding: .3em .8em; border: 1px solid #999; cursor: pointer;
         background: #fff; border-radius: 4px; }
 .cbtn.active { background: #2878fa; color: #fff; }
 #grid { display: flex; flex-wrap: wrap; gap: .8em; }
 .thumb { width: 180px; cursor: pointer; text-align: center; }
 .thumb img { width: 100%; border: 1px solid #aaa; background: #fff; }
 .thumb div { font-size: .7em; color: #555; word-break: break-all; }
 #full { position: fixed; inset: 0; background: rgba(0,0,0,.75);
         display: none; justify-content: center; overflow: auto; }
 #full img { max-width: 95%; margin: 1em; background: #fff; }
</style></head><body>
<h2>origami_tpu layout clusters</h2>
<div id="clusters"></div>
<div id="grid"></div>
<div id="full" onclick="this.style.display='none'"><img id="fullimg">
</div>
<script>
let groups = {};
async function load() {
  groups = await (await fetch('/clusters')).json();
  const bar = document.getElementById('clusters');
  bar.innerHTML = '';
  const ids = Object.keys(groups).sort((a, b) => a - b);
  for (const gid of ids) {
    const b = document.createElement('span');
    b.className = 'cbtn';
    b.textContent = gid + ' (' + groups[gid].length + ')';
    b.addEventListener('click', () => show(gid, b));
    bar.appendChild(b);
  }
  if (ids.length) show(ids[0], bar.firstChild);
}
function show(gid, btn) {
  for (const b of document.querySelectorAll('.cbtn'))
    b.classList.remove('active');
  if (btn) btn.classList.add('active');
  const grid = document.getElementById('grid');
  grid.innerHTML = '';
  for (const page of groups[gid]) {
    const d = document.createElement('div');
    d.className = 'thumb';
    const img = document.createElement('img');
    img.loading = 'lazy';
    img.src = '/thumb?page=' + encodeURIComponent(page);
    img.addEventListener('click', () => {
      document.getElementById('fullimg').src =
        '/image?page=' + encodeURIComponent(page);
      document.getElementById('full').style.display = 'flex';
    });
    const cap = document.createElement('div');
    cap.textContent = page.split('/').pop();
    cap.title = page;
    d.appendChild(img); d.appendChild(cap);
    grid.appendChild(d);
  }
}
load();
</script></body></html>"""


def _page_for_out(out_dir):
    """The page image a `<name>.out/` artifact dir belongs to."""
    out_dir = Path(out_dir)
    stem = out_dir.name[:-4] if out_dir.name.endswith(".out") \
        else out_dir.name
    for ext in (".png", ".jpg", ".jpeg", ".tif", ".tiff"):
        cand = out_dir.parent / (stem + ext)
        if cand.exists():
            return cand
    return None


def compute_clusters(data_path, k):
    """{cluster_id: [page_image_path, ...]} via the CLI's k-means."""
    from origami_tpu_torch.tool.cluster import load_signatures
    from origami_tpu_torch.tool.split import kmeans
    names, mat = load_signatures(data_path)
    pages = [(_page_for_out(n), n) for n in names]
    keep = [(p, i) for i, (p, n) in enumerate(pages) if p is not None]
    if not keep:
        return {}
    idx = [i for _, i in keep]
    assign, _ = kmeans(mat[idx], min(k, len(idx)))
    groups = {}
    for (page, _), a in zip(keep, assign):
        groups.setdefault(int(a), []).append(str(page))
    return groups


def page_view(page, max_w):
    """The page in gray, narrowed to `max_w` pixels when wider."""
    from origami_tpu_torch.batch.utils.thumbnail import resize_bicubic
    from origami_tpu_torch.core import _image
    px = _image.read_gray(page)
    h, w = px.shape
    if w > max_w:
        px = resize_bicubic(px, (max_w, int(h * max_w / w)))
    return px


def make_handler(groups):
    from origami_tpu_torch.core import _image, _jpeg
    known = {p for members in groups.values() for p in members}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code, body, ctype="text/html; charset=utf-8"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _jpeg(self, page, max_w):
            if page not in known:
                self._send(404, b"unknown page", "text/plain")
                return
            self._send(200, _jpeg.encode(page_view(page, max_w), 80,
                                         comment=_image.comment(page)),
                       "image/jpeg")

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(url.query)
            if url.path == "/":
                self._send(200, _PAGE.encode("utf-8"))
            elif url.path == "/clusters":
                self._send(200, json.dumps(
                    {str(k): v for k, v in sorted(groups.items())}
                ).encode("utf-8"), "application/json")
            elif url.path == "/thumb":
                self._jpeg(q["page"][0], 360)
            elif url.path == "/image":
                self._jpeg(q["page"][0], 2400)
            else:
                self._send(404, b"not found", "text/plain")

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.tool.cluster_web",
        description="Serve the browser cluster explorer for DATA_PATH.")
    p.add_argument("data_path", type=str)
    p.add_argument("-k", type=int, default=8)
    p.add_argument("--port", type=int, default=8396)
    p.add_argument("--host", type=str, default="127.0.0.1")
    add_device_argument(p)
    args = p.parse_args(argv)
    _device.resolve(args.device)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    groups = compute_clusters(args.data_path, args.k)
    if not groups:
        raise SystemExit(
            "no signatures under %s (run batch.utils.signature first)"
            % args.data_path)
    server = HTTPServer((args.host, args.port), make_handler(groups))
    n = sum(len(v) for v in groups.values())
    print("cluster UI on http://%s:%d (%d pages, %d clusters)"
          % (args.host, args.port, n, len(groups)))
    server.serve_forever()


if __name__ == "__main__":
    main()
