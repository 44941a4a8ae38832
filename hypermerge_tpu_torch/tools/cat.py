"""Print a doc's metadata + state, or dump a hyperfile's bytes to
stdout (the port of tools/cat.py; reference tools/Cat.ts + Meta.ts).

    python -m hypermerge_tpu_torch.tools.cat /path/to/repo 'hypermerge:/<docId>'
    python -m hypermerge_tpu_torch.tools.cat /path/to/repo 'hyperfile:/<fileId>' > out.bin

--device cpu runs the repo on the CPU (default: the GPU).
"""

import json
import sys
import tempfile

from ..models.plain import to_plain
from ..repo import Repo
from ..utils.ids import is_file_url
from . import add_device, device_of, parser


def main(argv=None) -> None:
    ap = parser("tools.cat", __doc__)
    ap.add_argument("repo", help="repo directory")
    ap.add_argument("url", help="doc or hyperfile url")
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_of(ap, args)

    repo = Repo(path=args.repo, device=device)
    if is_file_url(args.url):
        repo.start_file_server(tempfile.mktemp(suffix=".sock"))
        header, data = repo.files.read(args.url)
        print(
            f"# {header.mime_type}  {header.size} bytes",
            file=sys.stderr,
        )
        sys.stdout.buffer.write(data)
    else:
        meta = {}
        repo.meta(args.url, lambda m: meta.update(m or {}))
        print("META", json.dumps(meta, default=str), file=sys.stderr)
        print(json.dumps(to_plain(repo.doc(args.url)), default=str))
    repo.close()


if __name__ == "__main__":
    main()
