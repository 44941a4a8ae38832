"""Copy a local file into the repo as a hyperfile (prints its url), or
a hyperfile back out to disk (the port of tools/cp.py; reference
tools/Cp.ts).

    python -m hypermerge_tpu_torch.tools.cp /path/to/repo ./photo.png            # -> url
    python -m hypermerge_tpu_torch.tools.cp /path/to/repo 'hyperfile:/<id>' out.png

--device cpu runs the repo on the CPU (default: the GPU).
"""

import io
import mimetypes
import tempfile

from ..repo import Repo
from ..utils.ids import is_file_url
from . import add_device, device_of, parser


def main(argv=None) -> None:
    ap = parser("tools.cp", __doc__)
    ap.add_argument("repo", help="repo directory")
    ap.add_argument("src", help="local file, or a hyperfile url")
    ap.add_argument("dst", nargs="?", help="output path (url src only)")
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_of(ap, args)

    repo = Repo(path=args.repo, device=device)
    repo.start_file_server(tempfile.mktemp(suffix=".sock"))
    if is_file_url(args.src):
        header, data = repo.files.read(args.src)
        out = args.dst or "out.bin"
        with open(out, "wb") as fh:
            fh.write(data)
        print(f"{header.size} bytes ({header.mime_type}) -> {out}")
    else:
        mime = (
            mimetypes.guess_type(args.src)[0]
            or "application/octet-stream"
        )
        with open(args.src, "rb") as fh:
            header = repo.files.write(io.BytesIO(fh.read()), mime)
        print(header.url)
    repo.close()


if __name__ == "__main__":
    main()
