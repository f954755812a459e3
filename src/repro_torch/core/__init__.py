"""The paper's contribution: Kronecker operators (ketops), the word2ketXS
embedding and the kron vocab head."""
