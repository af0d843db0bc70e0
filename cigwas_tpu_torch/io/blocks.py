"""LD-block definitions and the `.blocks` text format.

Equivalent of `MarkerBlock` (`marker_block.h:7-61`) and
`read_blocks_from_file` (`io.cpp:74-101`), including the per-chromosome
global-offset bookkeeping.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class MarkerBlock:
    chr_id: str
    first_marker_ix: int  # index on the chromosome
    last_marker_ix: int
    chr_global_offset: int = 0

    def block_size(self) -> int:
        return self.last_marker_ix - self.first_marker_ix + 1

    def get_first_marker_global_ix(self) -> int:
        return self.first_marker_ix + self.chr_global_offset

    def get_last_marker_global_ix(self) -> int:
        return self.last_marker_ix + self.chr_global_offset

    def to_line_string(self) -> str:
        return f"{self.chr_id}\t{self.first_marker_ix}\t{self.last_marker_ix}"

    def to_file_string(self) -> str:
        return f"{self.chr_id}_{self.first_marker_ix}_{self.last_marker_ix}"

    def __eq__(self, other) -> bool:
        return (
            self.chr_id == other.chr_id
            and self.first_marker_ix == other.first_marker_ix
            and self.last_marker_ix == other.last_marker_ix
        )


def read_blocks_from_file(path: str) -> list[MarkerBlock]:
    """Parse a `.blocks` file; whitespace separated `chr first last` per line.

    Global offsets accumulate block sizes chromosome by chromosome exactly
    like `io.cpp:74-101` (the offset is the number of markers in *blocks* of
    all previous chromosomes).
    """
    blocks: list[MarkerBlock] = []
    global_offset = 0
    num_markers_on_chr = 0
    curr_chr = None
    with open(path) as fin:
        for line in fin:
            fields = line.split()
            if not fields:
                continue
            chr_id = fields[0]
            if chr_id != curr_chr:
                curr_chr = chr_id
                global_offset += num_markers_on_chr
                num_markers_on_chr = 0
            block = MarkerBlock(chr_id, int(fields[1]), int(fields[2]), global_offset)
            blocks.append(block)
            num_markers_on_chr += block.block_size()
    return blocks


def write_marker_blocks_to_file(blocks: list[MarkerBlock], path: str) -> None:
    """Append blocks to path (the reference opens with ios::app, `io.cpp:266-277`)."""
    with open(path, "a") as fout:
        for block in blocks:
            fout.write(block.to_line_string() + "\n")
