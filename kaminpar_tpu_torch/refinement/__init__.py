"""Host-side k-way refiners: FM with its gain caches, and the gated
Mt-KaHyPar adapter."""
