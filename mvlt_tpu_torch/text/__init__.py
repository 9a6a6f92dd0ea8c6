"""Text pieces of the port: the WordPiece tokenizer and its vocabulary."""

from mvlt_tpu_torch.text.tokenizer import (WordPieceTokenizer,
                                           find_default_vocab, load_vocab)

__all__ = ["WordPieceTokenizer", "load_vocab", "find_default_vocab"]
