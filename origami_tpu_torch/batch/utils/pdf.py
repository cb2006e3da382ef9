"""utils.pdf — convert PDFs into page images.

Port of origami_tpu/batch/utils/pdf.py, which renders each page through
PyMuPDF (`fitz`) and raises where it is missing. Neither machine the
port runs on has `fitz`; the conversion is the JAX function's, and
without the module it raises and names it.

    python -m origami_tpu_torch.batch.utils.pdf PDF -o DIR [--dpi 300]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def convert_pdf(pdf_path, out_dir, dpi=300):
    """Each page of the PDF as `<stem>-NNNN.png` in out_dir -> the number
    of pages. Raises RuntimeError without PyMuPDF (`fitz`)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        import fitz  # PyMuPDF
    except ImportError as e:
        raise RuntimeError(
            "no PDF backend available (PyMuPDF, module 'fitz', not "
            "installed); convert PDFs to page images externally") from e
    doc = fitz.open(str(pdf_path))
    n = 0
    for i, page in enumerate(doc):
        pix = page.get_pixmap(dpi=dpi)
        pix.save(str(out_dir / ("%s-%04d.png"
                                % (Path(pdf_path).stem, i + 1))))
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.utils.pdf",
        description="Convert PDF_PATH into page images under OUTPUT.")
    p.add_argument("pdf_path", type=str)
    p.add_argument("-o", "--output", type=str, required=True)
    p.add_argument("--dpi", type=int, default=300)
    args = p.parse_args(argv)
    if not Path(args.pdf_path).exists():
        raise SystemExit("no such path: %s" % args.pdf_path)
    try:
        n = convert_pdf(args.pdf_path, args.output, args.dpi)
    except RuntimeError as e:
        raise SystemExit(str(e))
    print("wrote %d pages." % n)


if __name__ == "__main__":
    main()
