"""Dense decoder layers and the ranker (``model.Ranker``)."""
