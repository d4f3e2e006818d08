"""One reference worker: reads ``(frames, family, max_num_of_boards,
control)`` pickled on standard input (written by ``detect_pool`` of this
package), writes the list of ``detect`` results pickled on standard
output.

    python3 -m benchmark.reference.worker < request > results
"""

from __future__ import annotations

import pickle
import sys

from benchmark.reference import detect


def main() -> None:
    frames, family, boards, control = pickle.loads(sys.stdin.buffer.read())
    out = [detect(f, family, boards, control) for f in frames]
    sys.stdout.buffer.write(pickle.dumps(out))
    sys.stdout.buffer.flush()


if __name__ == "__main__":
    main()
